"""PyTorch/CUDA port of the Visual RAG Toolkit retrieval pipeline.

The package mirrors ``repro`` module by module: token hygiene, model-aware
pooling, a segmented named-vector store and the 1/2/3-stage MaxSim cascade.
The three hot kernels (the MaxSim scan, the fused gather-rerank and the
index-time pooling) are hand-written CUDA C++ for Hopper (``csrc/``), built
with ``nvcc`` at first use and launched through ``ctypes``. Each kernel
wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors.

Entry points (``build_store``, ``IngestPipeline``, ``Retriever``,
``launch/serve.py``) run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

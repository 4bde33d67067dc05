#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                      # 4096 ColPali pages, 300 queries

Drives the port's main paths at full ColPali width (S=1030 tokens,
d=128, 34 ``mean_pooling`` vectors) and fails (exit code != 0, no result
line) at the first phase that goes wrong:

1. device   a CUDA device is present; prints nvidia-smi's name and power
            limit;
2. build    compiles the CUDA libraries from ``src/repro_torch/csrc`` (one
            nvcc per source, in parallel) and prints the seconds;
3. kernels  holds each kernel against its plain PyTorch version on the
            card at the main paths' shapes (f32, bf16 and int8 docs, dead
            ``doc_valid`` slots, fully masked documents and candidates, a
            broadcast mask, ragged N and D, a Matryoshka prefix, clipped
            candidate rows, N no multiple of the chunk), printing each
            tolerance and the largest error, and the route of each
            checked scan, db scan and rerank shape as the scan library
            states it (tensor: bf16 wgmma over the packed valid query
            tokens, split into bf16 hi + lo parts; warp: f32 on the CUDA
            cores); queries of 96 and 128 tokens at d=128 through the
            scan (both routes), the db scan, the rerank and
            ``centroid_scores``; a fully masked rerank candidate must
            score Qv * NEG on both routes;
            ``quantize_int8`` on the card must give the CPU's codes and
            scales bit for bit, and an empty query batch or corpus must
            count no launch; ``centroid_scores`` (the scan kernel's warp
            route on a D=1 view of a [64, 128] centroid table) against
            its plain product; the SASS of the scan, db scan and rerank
            libraries must each hold HGMMA;
3b. embed   the ``embed_bag`` op at three shapes: ``kernel_micro``'s
            (table [100000, 64] f32, bags [4096, 8]), the same with a
            bf16 table, and a table the size of Criteo-1TB's largest
            field ([39979771, 128] f32, 20.5 GB, made on the card) with
            bags [16384, 100]; -1 padding, both modes, with and without
            a ``valid`` mask, held against the plain version at
            rtol=1e-5, atol=1e-5; then the op's own run (counts zeroed
            before, read after) and its times; last, f32 and bf16 tables
            with inf and NaN in the rows that padded and masked-out slots
            point at: NaN in the plain version's places (0 * inf, as in
            the reference), the rest as above;
4. main     indexes the synthetic benchmark through ``IngestPipeline``
            (pooling kernel) in batches of 256 pages, then runs the 1/2/3-
            stage cascades through ``Retriever.search`` with the scan and
            rerank kernels, in query batches; every kernel's launch count
            over this phase must be > 0. The same cascades through the
            plain path on the card must give the same top-10 ids (apart
            from near-exact ties) and the same NDCG/Recall@5/10 to 3
            decimals, and the plain engine must match the
            ``multistage.search`` oracle. Here and in 4b-4e and 4i the
            plain side ranks one result deeper (k + 1), so that a tie of
            the 10th with the 11th plain score is seen as a tie. After
            4d, ``[cost]`` lines print the cascade cost model for phase
            4's float cascades, 4b's int8 ones and 4d's routed 2-stage
            (n_probe 64 and 8): ``multistage.qps_cost_model``'s
            multiply-adds a query and their ratio to the 1-stage
            cascade's, ``cascade_hbm_bytes``' bytes a batch of 32 per
            stage and in all, those bytes at 3.35 TB/s, and the run's
            measured ms a batch (no limit);
4b. int8    indexes the corpus again as ``serve.py --int8`` does:
            ``IngestPipeline`` pools and quantises each 256-page batch
            (the scan vector's float copy dropped when no later stage
            reranks on it) and ``Retriever.upsert`` adds the quantised
            batches; their codes and scales must equal ``quantize_store``
            over the phase-4 store bit for bit. It then runs int8
            cascades with ``use_kernel``, ``chunk=256``
            and ``rerank_kernel``: 1-stage over ``initial`` codes (the
            double-buffered scan), 2-stage over ``mean_pooling`` codes (the
            double-buffered scan, bf16 rerank), 2-stage with an int8 rerank
            onto ``initial`` codes, and two ``scan_topk`` cascades (the
            int8 scan kernel per chunk). Each new kernel must launch; ids
            and metrics must equal the plain path's as in phase 4;
4c. filter  the phase-4 pages upserted in groups of 64, each group
            stamped with one of 8 tenants and 8 of 64 tags (2 filter
            words); the 2-stage kernel cascade under three ``FilterSpec``s
            must return no id outside the filter, the ids and scores of an
            unfiltered search over a store rebuilt from only the matching
            pages (bit for bit expected: each (query, document) pair is
            scored alone), and the plain filtered path's ids;
4d. routed  the phase-4 pages with ``Retriever(routing=RoutingPolicy(64))``;
            the 2-stage kernel cascade at full probe (``n_probe`` 64) must
            give the exhaustive cascade's NDCG/Recall@5/10 to 3 decimals
            and its ids apart from exact-score ties; at ``n_probe`` 8 it
            prints recall@10 against the exhaustive ids and QPS; the
            ``ivf_route`` and ``maxsim_rerank`` counts must be > 0;
4e. dtype   the 2-stage cascade with ``Stage.dtype="bfloat16"`` through
            the kernels against the plain path, as in phase 4;
4f. dup     the phase-4 pages plus a copy of the first 256 (exact ties):
            the routed 2-stage kernel cascade at full probe must give the
            exhaustive ids exactly;
4g. ingest  the phase-4 pages through ``Retriever.ingest`` (the fused
            write: index the bucket-padded batch with the pooling kernel,
            one slice copy per array into the segment tail) in batches of
            64 into a store seeded with the first batch: every segment
            array must equal ``IngestPipeline.index`` + ``add_pages`` of
            the same batches bit for bit, no batch after the first of its
            bucket may build anything (``retrieval.tracing``), and the
            2-stage kernel cascade over it must give phase 4's NDCG@10;
            prints pages/s of both paths, and ``index`` of 129 pages
            (padded to 256) against the same pages unpadded and against
            128 pages, the cost of bucket padding; then ``serve.py
            --ingest-pipeline`` (512 pages, 8 batches of 64) must report
            0 steady-state builds;
4h. front   a ``ServingFrontend`` (max_batch 16, max_q 32, flush 2 ms,
            warmed) over the 2-stage kernel cascade: (s) the benchmark
            queries all due at once (the served rate is the frontend's
            capacity in this run) and (a) replayed open loop at half that
            capacity must give phase 4's NDCG@10; (b) the same queries cut
            to 4-16
            token slots (lengths drawn from ``--seed``), replayed the same
            way: every result must equal a per-request
            ``Retriever.search`` of the cut query bit for bit, and some
            dispatched block must hold padded rows (no valid token); no
            build over the traffic; prints p50/p99 latency, dispatches and
            the padded-row share; then ``serve.py --traffic 300 --int8
            --chunk 256`` (512 pages; the double-buffered scan) must
            report 0 builds;
4i. mrl     ``add_truncated_stage(..., "mean_pooling", 32)`` over the
            phase-4 pages: the cascade (mean_pooling_mrl32, 128),
            (initial, 10) through the kernels (the d=32 scan on the
            tensor route) must give the plain path's ids apart from
            near-exact ties and its metrics to 3 decimals; then
            ``examples/quickstart_torch.py`` runs on the card and on the
            CPU, and its ``[search]`` lines must be equal;
4j. tiered  the phase-4 pages as 8 segments of 512 (139 MB each) behind a
            ``TieredEngine`` whose budget holds 3 (the other 5 in pinned
            host memory, promoted on a copy stream): (a) the 2-stage
            kernel cascade over the whole corpus with prefetch overlap on,
            then off, (b) a hot scope of 2 segments (0 promotions after
            warm-up), (c) scopes alternating hot and cold (0 builds),
            then the whole corpus behind a ~0.1 s sleep on the compute
            stream (demotions of segments whose scans are still queued),
            (d)
            a deadline of half a promotion with ``DegradePolicy()``
            (degraded results flagged, their scores exact), (e) a
            ``FaultPlan`` with transfer failures, then one killing the
            worker (retries and restarts counted); every undegraded result
            must equal the resident search bit for bit, and the engine's
            peak device memory stay within the budget plus one segment
            plus the resident search's working set. (f) snapshots the
            store (segments on both tiers), restores it bit for bit and
            finds a bit flipped on disk (``CheckpointCorrupt`` names the
            leaf); (g) an int8 store (db scan with chunk 256, int8 rerank)
            through its own engine, bit for bit its resident search.
            Prints QPS, promotions, bytes and GB/s, and the host->card
            rates of one segment from pinned and from pageable memory;
4k. train   the ColX encoder (``models/late_interaction.py``) and its
            training path at ColPali width (d_model 1024, 16 heads, d_ff
            4096, S=1030, out_dim 128, query_vocab 32768), f32 with TF32
            off, batches from ``examples/train_retriever_torch.py``'s
            ``synth_batch``: (a) a 2-layer model, batch 4, on the card
            against the same seeded model on the CPU: loss within rtol
            1e-5, every gradient within rtol 1e-3, atol 1e-6; (b) the
            16-layer config, batch 16, ``OptConfig(lr=3e-4, warmup=20)``:
            2 warm-up and 10 timed steps (CUDA events) and one step
            under ``torch.profiler`` (device time of GEMM, softmax and
            other kernels), every loss and grad_norm finite, the lr
            sequence the schedule's; prints ms/step, pages/s, FLOPs
            (formula printed), TFLOP/s and peak memory; (c) the train
            state checkpointed after step 13 in
            ``repro``'s ``{"p", "o"}`` format and restored into a fresh
            model: bit for bit, and the next 2 losses equal the
            uninterrupted run's within rtol 1e-5; write and restore
            GB/s; (d) the trained encoder encodes 512 pages (batches of
            64) and their 8-token queries; ``Retriever.ingest`` indexes
            them (pooling kernel, bf16 store) and the 2-stage(256, 10)
            cascade through the scan and rerank kernels must give the
            plain path's ids apart from near-exact ties and its
            recall/NDCG@5/10 to 3 decimals (query i's page is page i);
            pooling, scan and rerank must each launch. 4k runs after
            phase 5 has timed the kernels, so that neither its training
            load nor its profiled step comes before those times;
4l. lm      the decoder-LM family (``models/transformer.py``, after 4k):
            (a) each of the five LM archs at the launcher's
            ``reduced_lm`` size, f32: loss, logits and every gradient of
            one step on the card against the CPU (loss rtol 1e-5, logits
            rtol 1e-5 atol 1e-5, gradients rtol 1e-3 atol 1e-6); (b)
            minicpm-2b at full width and depth (40 layers, 2.725e9
            params, vocabulary padded to 122880), bf16, through
            ``launch/train.py``'s own build, batches and step at its
            defaults (batch 8, seq 128, WSD): 2 warm-up + 5 timed steps,
            a forward + backward alone and one profiled step; every loss
            and grad_norm finite, the lr sequence the schedule's; prints
            ms/step, tokens/s, FLOPs (formula printed), TFLOP/s and peak
            memory; (c) gemma3-4b at full width and depth (34 layers,
            head_dim 320, 5:1 local:global, 1024 window), f32 with TF32
            off: prefill B=2, S=1536 (the ring rolls) with
            decode_budget 16, then 16 greedy decode steps, whose first
            and last logits must equal a full forward over the prefix
            (rtol 2e-3, atol 2e-3); then the same in bf16, timed: prefill
            ms, decode ms per step, cache bytes, peak memory; (d)
            granite-moe-1b-a400m at full width and depth (24 layers, 32
            experts top 8), f32, batch 4 x 256: ``moe_dense`` and
            ``moe_ragged`` losses within rtol 1e-3 and every layer's
            router ids equal (apart from ties within 1e-4), then one
            train step timed under each; (e) the launcher at
            ``--reduced --steps 21 --ckpt-every 11 --ckpt-dir``, run
            twice: the second run must print ``[resume] from step 10``
            and repeat the first run's losses of steps 11-20 (rtol
            1e-5);
4m. recsys  the recsys family (``models/recsys/``, after 4l): (a) dcn-v2,
            autoint, dlrm-mlperf and bert4rec at the CPU tests' sizes,
            one seeded model on the host copied to the card: loss rtol
            1e-5, every gradient rtol 1e-3 atol 1e-6, ``serve_step`` rtol
            1e-5 atol 1e-6, 1- and 2-stage ``retrieval_step`` over 300
            candidates (ids equal apart from scores tied within 1e-5,
            scores rtol 1e-5 atol 1e-6), 5 train steps (losses rtol 1e-4,
            the last below the first); then each arch at its full config
            (dlrm-mlperf's fields capped at 4194304 rows, 12.82 GB; the
            cap printed as a reduction): (b) serve_p99, batch 512, 200
            synchronised calls (p50, p99, rows/s); (c) serve_bulk, 262144
            rows in 8 chunks of 32768 (ms, rows/s, peak memory; the first
            chunk bit for bit a direct call); (d) retrieval_cand, one query
            against 10^6 candidates: exact 1-stage, 2-stage (prefetch 256,
            top 100, d_proxy 16) and 2-stage over a ``cand_proxy`` [N, 16]
            table (ms, QPS, recall@100 against the exact ids, 2-stage /
            1-stage QPS; every final score the full model's, rtol 1e-5
            atol 1e-6; at N 65536 with prefetch N the 2-stage ids equal
            the 1-stage ids); (e) train_batch, batch 65536 (bert4rec the
            largest of 65536, 32768, 16384, 8192 that fits, printed), 2
            warm-up + 10 timed steps (ms/step, examples/s, TFLOP/s by 3 x
            ``cells.py``'s dense FLOPs, peak memory; losses and grad_norms
            finite, lr the schedule's); after 4l's and 4k's profiles, one
            step of each arch under ``torch.profiler`` (busy and GEMM
            shares) and split by phase (forward, backward, update);
4n. gnn     the GNN family (``models/gnn/``, after 4m's timed parts,
            before 4k): (a) EquiformerV2 at the CPU tests' size, f32,
            fused rotation off and on, one seeded model on the host
            copied to the card: forward rtol 1e-5 atol 1e-5, loss rtol
            1e-5, every gradient rtol 1e-3 atol 1e-6, a 4-graph molecule
            loss rtol 1e-5, fused against unfused forward rtol 1e-5 atol
            1e-5, the l=0 outputs under a random global rotation rtol
            1e-3 atol 1e-4; then equiformer-v2 at full width (12 layers,
            128 channels, l_max 6, m_max 2, 8 heads), bf16 messages,
            ``OptConfig()``, base and opt (fused rotation), 2 warm-up +
            5 timed steps each (ms/step, edges/s, TFLOP/s by
            ``cells.py``'s ``_gnn_flops``, printed, peak memory; losses
            and grad_norms finite, lr the schedule's): (b) ``molecule``
            (128 graphs x 30 nodes x 64 edges as one disjoint union) and
            ``full_graph_sm`` (2708 nodes, 10556 edges); (c)
            ``minibatch_lg``: a fanout-(15, 10) subgraph of 1024 seeds
            (512 or 256 where 1024 does not fit, printed as a reduction)
            from ``random_graph(232965, 492)``, whose generation, CSR
            build and sampling times on the host are printed apart;
            ``ogb_products`` is printed as not run; (b) also shows, not
            timed, the reference model's gradients on the molecule
            batch with positions normal x 2 (edges past the 8.0
            cutoff): the timed steps keep every edge inside it; after
            4m's profiles, one ``full_graph_sm`` step (base) under
            ``torch.profiler`` (busy, GEMM, scatter, gather and
            elementwise shares);
4o. cells   ``launch/cells.py``'s cells (after 4n's timed parts, before
            4k): (a) every cell of ``get_cells(ALL_ARCHS)`` x its
            variants (101) built on ``meta``: parameters, argument GB,
            ``model_flops`` (for the train cells of the LMs and the
            retrievers also this script's ``lm_step_flops`` and
            ``train_step_flops``, which count the remat forward, the
            query tower and the score matrix on top), and whether the
            arguments alone exceed the card's memory; nothing allocated;
            (b) on the card at full shape, 1 warm-up and 3 calls timed by
            CUDA events each (ms, ``model_flops``/ms as TFLOP/s): the
            three retrievers' ``index_1m`` (256 pages under
            ``torch.inference_mode``, pooling through ``pool.cu``, held
            against ``pool_ref`` at rtol 1e-5, atol 1e-5), dcn-v2's four
            cells (base) and ``retrieval_cand`` opt, equiformer-v2's
            ``molecule`` (base), each beside 4m's or 4n's time in this
            run; (c) colpali ``search_1m`` stage1, base and opt at a corpus
            cut to 131072 pages (the cut printed), 64 queries a call
            (QPS), queries 0-7 held against the plain path (ids equal
            apart from near-exact ties at the 100th and the 256th cut-off,
            scores rtol 1e-5, atol 1e-4); (d) minicpm-2b ``train_4k`` and
            gemma3-4b ``prefill_32k`` and ``decode_32k`` at batch 1 (the
            cut printed; a cell whose arguments do not fit is printed as
            not run). The cells' own calls must launch the pool, scan,
            rerank and an int8 scan or db scan kernel;
4p. mesh    the retrieval mesh path (after 4j, before phase 5): the
            phase-4 corpus on ``make_mesh((4,), ("data",),
            devices=["cuda:0"] * 4)``, 4 shards time-sliced on this one
            card, each shard's slab scanned and reranked by the kernels,
            the shards' (score, id) lists gathered in mesh order, held
            against the single-device kernel path of this run: (a) a
            1-position mesh gives the 1-, 2- and 3-stage results of phase
            4 bit for bit; (b) on 4 shards (4c's tenants and tags) the 1-,
            2- and 3-stage cascades, 4b's int8 stores placed on the mesh
            (db scan, ``scan_topk``, int8 rerank), 4c's first filter and
            routed search (one clustering of the whole segment, equal to
            4d's on every slab; full probe and ``n_probe`` 8) give the
            one-device scores bit for bit, its ids apart from exact ties
            and the same NDCG@10 to 3 decimals, full probe the
            exhaustive metrics; (c) the first 4093 pages (capacity 4160,
            slabs of 1040), 64 pages ingested through the pooling kernel
            (tenant 1), 10 deleted: the scores of a one-device store
            rebuilt from the survivors bit for bit and its ids apart
            from exact ties, a
            2-stage(256, 100) over the 60 live tenant-1 pages holds each
            once per row and -1 after, and nothing is built after
            warm-up; (d) 8 segments of 512 pages behind a ``TieredEngine``
            with a budget of 3: bit for bit the resident mesh search; a
            snapshot restored onto the mesh answers bit for bit, restored
            onto one device with the same scores bit for bit and the
            same ids apart from exact ties; (e) QPS at one device, 1 and
            4 shards, per-shard scan and rerank kernel ms against the
            whole store's (the rerank scores all 256 rows on every
            shard), search peak memory, the phase's seconds; (f) the
            2-stage cascade on the 4 shards at ``rerank_overcommit`` 1,
            2 and 8 (``cap_slots`` 64, 128, 256 of 256): at 8 (b)'s
            result bit for bit, at 1 and 2 every query row whose
            stage-0 candidates no shard owns more than ``cap_slots`` of
            gives overcommit 8's ids and scores bit for bit, and the other
            rows' count, their recall@10 against overcommit 8, NDCG@10,
            QPS and the per-shard rerank kernel ms at ``cap_slots`` rows
            are printed; a store built with ``place=False`` (split over
            the mesh on each call) gives the placed 1- and 2-stage
            results bit for bit, with its QPS. The mesh
            runs must launch the scan, rerank, pool, db scan, int8 scan,
            int8 rerank and ``ivf_route`` kernels, and their launches
            join the kernels line;
4q. shard  the sharded model bodies (``distributed.shard_map``: one
            thread per mesh position, collectives as joint autograd
            nodes) on 4 positions of this one card, after 4k: (a) bodies
            around psum (one and both axes of (2, 2)), all_gather (tiled,
            stacked), all_to_all (rows, columns), a checkpointed
            all_to_all replayed in the backward and an unreduced value
            under P(): values and input gradients on ``["cuda:0"] * 4``
            equal ``["cpu"] * 4`` bit for bit; (b) EquiformerV2's vertex
            cut at S = 4 and minibatch cell at dp = tp = 2
            (``cells.vertex_cut_loss``, ``cells.minibatch_loss``): at the
            CPU tests' size in f32 with remat on, loss (rtol 1e-5) and
            every gradient (rtol 1e-3, atol 1e-6) against the CPU mesh;
            at full width (bf16 messages) on full_graph_sm's sizes (2708
            nodes, 10556 edges), ms/step, peak memory and the all_to_all
            bytes a layer, losses finite; (c) granite-moe-1b-a400m with
            ``ragged_ep`` over (1, 4): 2 full-width layers in f32 against
            the CPU mesh (loss rtol 1e-5, gradients rtol 1e-3, atol
            1e-6), all 24 layers at 4l (d)'s batch: ms/step beside 4l
            (d)'s ragged step, the share of dropped assignments, and the
            loss equal to ``moe_ragged``'s within rtol 1e-5 where none
            was dropped; (d) dlrm-mlperf's capped table (12.82 GB) in 4
            row slabs: ``lookup_shardmap`` == ``lookup`` bit for bit at
            batch 65536, ms of each; (e) dcn-v2's 2-stage search over
            10^6 candidates with the two-level top-k at S = 4: ids equal
            the one-level ids apart from ties within 1e-5, ms of each;
            (f) ``psum_compressed`` over (4,) on EquiformerV2's gradient
            tree: bit for bit the CPU mesh, GB/s; (g) granite-moe's
            ``param_specs`` resolved at (2, 2), resharded onto (1, 4)
            with ``reshard_tree`` and restored from a checkpoint with
            ``shardings=``: every slab equals its slice bit for bit.
            Nothing here launches a hand-written kernel (the bodies are
            ``repro``'s einsum, take and segment work);
4r. part   the partitioned cells (``repro``'s ``jax.jit(...,
            in_shardings=...)`` cells: every argument placed as per-position
            slabs by its sharding, the step on the slabs with explicit
            collectives) on 4 positions of this one card, after 4q: (a) at
            the CPU tests' sizes in f32 on ``["cuda:0"] * 4`` against
            ``["cpu"] * 4``: minicpm-2b train base on (2, 2), the 3-head
            1-kv-head ZeRO + ``seq`` configuration train on (2, 2) (loss
            rtol 1e-5, every moment, 0.1 x the clip-scaled gradient, rtol
            1e-3, atol 1e-7), gemma3-4b (windows of 8) prefill and 4 decode
            steps (logits rtol 1e-5, atol 1e-5), ``molecule`` on (4, 1) with
            f32 messages, colpali train on (4, 1), colpali index on (4, 1)
            (each position's f32 pooled vectors rtol 1e-5, atol 1e-5); (b)
            at full width beside the one-device cell on the same weights
            and batch (ms per step or call, each position's parameter and
            optimizer-state bytes beside the whole, bytes between positions
            per collective, peak memory): minicpm-2b ``train_4k`` base on
            (2, 2) at 16 of its 40 layers (the placed state of 4 positions
            on one card), batch 2 x 4096, bf16 (first-step loss within rtol
            2e-3 of the one-device step); granite-moe base (``moe_dense``,
            experts over tp = 4) f32 at 4l (d)'s batch; colpali
            ``train_contrastive`` on (4, 1) at batch 16; ``molecule`` on (4,
            1) at its full shape; gemma3-4b f32 prefill 2 x 2048 on (1, 4)
            (last logits rtol 1e-5, atol 1e-5) and 16 decode steps on (2, 2)
            fed the one-device greedy tokens (the same greedy token apart
            from near-ties within 1e-4); colpali ``index_1m`` on (4, 1), 256
            pages, ``pool.cu`` launched once a position and call (its
            launches join the kernels line). The recsys cells and
            ``full_graph_sm`` (their tables row-split over tp, their
            candidates or edges over ``flat``): (a) the four archs' train
            step (row-wise accumulators' roots rtol 1e-3), ``serve_p99``,
            ``serve_bulk`` in chunks of 8 (rtol 1e-5, atol 1e-6) and
            ``retrieval_cand`` base and opt over 301 candidates (ids equal
            apart from ties within 1e-5) on (2, 2) and (1, 4), and
            ``full_graph_sm`` base and opt on (2, 2) with f32 messages;
            (b) dcn-v2, autoint, bert4rec on (2, 2) and dlrm-mlperf (4m's
            capped table) on (1, 4): ``serve_p99``, ``serve_bulk``
            (bert4rec in chunks of 16384), ``retrieval_cand`` base and opt
            over 10^6 candidates and ``train_batch`` (bert4rec 8192)
            beside the one-device calls on the same weights (kept on the
            host) and inputs: first-step loss rtol 1e-5, outputs rtol
            1e-4, atol 1e-5, ids equal apart from ties within 1e-5; and
            ``full_graph_sm`` base and opt on (2, 2) at full shape (loss
            within 2^-8);
4s. dry    the dry run (``launch/dryrun.py`` over ``op_analysis``,
            after 4r; it launches no kernel): (a) every cell of
            ``get_cells(ALL_ARCHS)`` x its variants (101) on the 16 x 16
            (data, model) mesh of ``meta`` devices, one position's run
            each (``shard_map`` bodies once, as position 0; kernels
            record their cost), in worker processes: a line per cell
            with the argument, held and peak GB a position, TFLOP a
            position, collective GB by kind and whether the peak fits
            this card's ``total_memory``; all 101 must be ok, no worker
            may touch CUDA and this process's ``memory_allocated`` must
            not move; (b) minicpm-2b ``train_4k`` at 16 layers on (2, 2),
            dlrm-mlperf ``train_batch`` (4m's capped table) on (1, 4) and
            bert4rec ``train_batch`` at 8192 on (2, 2), 4r's sizes: each
            cell's dry run on a meta mesh of its shape, its held bytes a
            position times the 4 positions of ``cuda:0`` within 1% of
            the growth of ``memory_allocated`` over the build on the
            card; its peak a position printed beside one step's
            ``max_memory_allocated`` (not held: the 4 positions take
            turns on one card);
4t. audit  the port's contract auditor (``repro_torch.analysis``, after
            4s): (a) the AST layer over this checkout's
            ``src/repro_torch`` has no gated finding (R1-R5); (b) the op
            audit's six scenarios (``op_audit.SCENARIOS``, the JAX
            auditor's geometry) built on the card with their kernels:
            no gated D1-D4 finding, and each scenario's launches show a
            kernel of its path; (c) after one warm call, each body runs
            once more under ``torch.cuda.set_sync_debug_mode("error")``,
            where any synchronising CUDA call raises; (d) each
            scenario's ids (the ingest's int8 codes) equal its CPU run's
            apart from near-exact ties within 1e-4 (codes: bit for bit);
            (e) each body's ``max_memory_allocated`` growth over one warm
            call beside the audit's largest op output, printed only;
5. times    each kernel's median time (CUDA events) at the main path's
            shapes beside its plain version, one PyTorch library call
            computing the same function, and its bound: the larger of the
            bytes it must move at 3.35 TB/s and the operations this run's
            data needs at the H100's float32 rate (67 TFLOP/s). The scan
            and rerank also print a second bound: the same bytes against
            a split-precision product on the bf16 tensor cores (q as bf16
            hi + lo parts, two products per multiply-add at 989 TFLOP/s),
            which keeps near-f32 accuracy over the bf16 documents (int8
            codes are exact in bf16, so the same bound holds for them).
            The tensor-route scan, db scan and rerank compute exactly
            that, so their JSON bound is the split one; the rerank's
            bytes are its distinct candidates' rows, read once. Every
            ``ms`` times one wrapper call per sample on the inputs the
            main path gives it (bool masks; the tensor route packs its
            query on every call), as earlier PRs did; ``kernel_ms``
            (scans, db scan, rerank) is the launch with the packed query
            built once, and ``b2b_ms`` (those and the pool) the mean of
            5 wrapper calls enqueued back to back per sample. The main
            path's db scan and rerank shapes must take the tensor
            route.

The last two lines are a JSON object with one entry per kernel and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM float32 (CUDA cores)
BF16_TC_FLOPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
NEG = -1e30
LAG_CYCLES = 200_000_000           # ~0.1 s of torch.cuda._sleep at 1.98 GHz


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 10, reps: int = 1) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events), after one
    warm-up call: each of ``iters`` samples times one call (the JSON
    ``ms``), or with ``reps`` > 1 the mean of that many calls enqueued
    back to back, so that the host's work of a call overlaps the card's
    work of the one before (the JSON ``b2b_ms``)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def bound_split_bf16(nbytes: float, flops: float) -> tuple:
    """(bound_ms, bound_by) for the same work as a split-precision product
    on the bf16 tensor cores: the f32 query as bf16 hi + lo parts against
    the bf16 documents, so two tensor-core operations per f32 one."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * flops / BF16_TC_FLOPS_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def rerank_cost(q, qm, rows, dm, D: int, row_bytes: int) -> tuple:
    """(bytes, operations, distinct candidates) of a rerank: the distinct
    candidates' rows (``row_bytes`` per document vector: the vector, its
    mask byte and an int8 scale) read once, candidates that several
    queries share counted once; the rows, query, query mask and output;
    2*d operations per (valid query token, unmasked candidate vector)."""
    B, L = rows.shape
    uniq = torch.unique(rows).numel()
    vecs_needed = int(dm[rows.long()].sum(-1).float().mul(
        qm.sum(-1, keepdim=True).float()).sum())
    nbytes = (rows.numel() * 4 + q.numel() * 4 + qm.numel() * 4
              + uniq * D * row_bytes + B * L * 4)
    return nbytes, 2.0 * vecs_needed * q.shape[-1], uniq


def log_bounds(what: str, ms: float, nbytes: float, flops: float) -> None:
    """Print the f32 and the split-bf16 tensor-core bound of one timed
    kernel, each with the kernel's share of it."""
    parts = []
    for label, (b_ms, b_by) in (("f32 CUDA cores", bound(nbytes, flops)),
                                ("split bf16 tensor cores",
                                 bound_split_bf16(nbytes, flops))):
        parts.append(f"{label} {b_ms:.4f} ms ({b_by}), kernel at "
                     f"{100 * b_ms / ms:.2f}%")
    log(f"[bounds] {what}: " + "; ".join(parts))


def max_err(got, want, what: str, rtol: float, atol: float) -> float:
    """Assert ``got`` ~ ``want`` (sentinel entries at or below -1e20 must
    sit there in both) and return the largest abs error over the rest."""
    got, want = got.float(), want.float()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != "
          f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    sent = want <= -1e20
    check(bool(((got <= -1e20) == sent).all()),
          f"{what}: sentinel (NEG) entries differ")
    try:
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    except AssertionError as e:
        fail(f"{what}: kernel != plain version (rtol={rtol}, atol={atol}): "
             f"{e}")
    live = ~sent
    err = float((got[live] - want[live]).abs().max()) if live.any() else 0.0
    log(f"  {what}: ok (rtol={rtol}, atol={atol}), max abs err "
        f"{err:.3e}")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def unit(gen, shape, dtype, device):
    x = torch.randn(shape, generator=gen, device=device)
    return (x / x.norm(dim=-1, keepdim=True)).to(dtype)


def chunked_scan_ref(maxsim_ref, q, qm, docs, dm, chunk=256):
    """The scan's plain version over N in chunks (its [B, N, Q, D]
    similarity block does not fit at corpus scale)."""
    return torch.cat([maxsim_ref(q, qm, docs[i:i + chunk], dm[i:i + chunk]
                                 if dm.shape[0] > 1 else dm)
                      for i in range(0, docs.shape[0], chunk)], dim=1)


def scan_route(docs, what: str, d: int | None = None,
               kernel: str = "scan") -> str:
    """The launcher's route for ``docs`` (scored at vector dim ``d``,
    the documents' own by default) as the scan library states it
    (``maxsim_scan_route``, the rule the scan, db scan and rerank
    launchers apply and their wrappers ask); printed with the tensor
    route's query tokens per group (scans) or per pass (rerank)."""
    from repro_torch.kernels.maxsim import ops as KOPS
    N, D, dd = docs.shape
    d = dd if d is None else d
    route = KOPS.scan_route(docs.dtype, D, d)
    if route != "tensor":
        how = " (f32 warp on the CUDA cores)"
    elif kernel == "rerank":
        how = (" (bf16 wgmma m64n32k16, split-precision query, 16 query "
               "tokens per pass)")
    else:
        how = (" (bf16 wgmma, split-precision query, "
               f"{KOPS.scan_token_cap(docs.dtype, d)} query tokens per "
               "group)")
    log(f"  route {what}: {route}{how}")
    return route


def hgmma_count(name: str) -> int:
    """HGMMA (wgmma) instructions in the SASS of library ``name``."""
    from repro_torch.kernels import build
    from torch.utils.cpp_extension import CUDA_HOME
    so = build._lib_path(name)
    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, timeout=300).stdout
    return sass.count("HGMMA")


def check_kernels(args, dev) -> dict:
    from repro_torch.kernels.maxsim import ops as KOPS
    from repro_torch.kernels.maxsim.ref import maxsim_ref
    from repro_torch.kernels.pooling import ops as POPS
    from repro_torch.configs import get_config

    cfg = get_config("colpali")
    gen = torch.Generator(device=dev).manual_seed(1234)
    B, Q, Qv, d = args.batch, 16, 10, cfg.out_dim
    N = args.pages
    q = unit(gen, (B, Q, d), torch.float32, dev)
    qm = torch.zeros((B, Q), dtype=torch.bool, device=dev)
    qm[:, :Qv] = True
    errs = {"maxsim_scan": 0.0, "maxsim_rerank": 0.0, "pooling": 0.0}
    tol = dict(rtol=1e-5, atol=1e-4)
    log(f"[kernels] tolerance: rtol={tol['rtol']}, atol={tol['atol']} on "
        f"scores of {Qv} unit-vector tokens (f32 sums in another order; the "
        "tensor-route scan adds the split query's last bits, q_hi + q_lo "
        "within 2^-16 relative of q); pooling rtol=1e-5, atol=1e-5")

    # --- scan: mean_pooling [N,34,d] and initial [N,1024,d], bf16 + f32
    for name, D in (("mean_pooling", cfg.n_pooled),
                    ("initial", cfg.n_patches)):
        docs = unit(gen, (N, D, d), torch.bfloat16, dev)
        dm = torch.rand((N, D), generator=gen, device=dev) > 0.05
        dm[3] = False                                # a fully masked doc
        valid = torch.rand((N,), generator=gen, device=dev) > 0.1
        scan_route(docs, f"scan bf16 {name} [{N},{D},{d}]")
        got = KOPS.maxsim_scores(q, docs, qm, dm, valid)
        want = chunked_scan_ref(maxsim_ref, q, qm, docs, dm)
        want = want.masked_fill(~valid[None, :], NEG)
        errs["maxsim_scan"] = max(errs["maxsim_scan"], max_err(got, want, f"scan bf16 {name} [{N},{D},{d}] doc_valid",
            **tol))
        check(bool((got[:, 3] < -1e20).all()),
              "scan: a fully masked doc must sink")
        del docs, dm
    # ragged N and D, broadcast (absent) mask: f32 docs (warp route), bf16
    # docs (tensor route, tiles across documents), a query with no token
    qz = qm.clone()
    qz[1] = False
    for dt in (torch.float32, torch.bfloat16):
        docs = unit(gen, (1001, 37, d), dt, dev)
        r = scan_route(docs, f"scan {str(dt)[6:]} [1001,37,{d}]")
        got = KOPS.maxsim_scores(q, docs, qz, None)
        want = maxsim_ref(q, qz, docs, torch.ones((1, 37), device=dev))
        errs["maxsim_scan"] = max(errs["maxsim_scan"], max_err(
            got, want, f"scan {str(dt)[6:]} ragged [1001,37] broadcast mask, "
            f"query 1 with no token ({r} route)", **tol))

    # long queries (Q = 96 and 128 at d = 128) through the scan (both
    # routes), the rerank and centroid_scores
    docs = unit(gen, (300, 100, d), torch.bfloat16, dev)
    dm = torch.rand((300, 100), generator=gen, device=dev) > 0.05
    cents = torch.randn((64, d), generator=gen, device=dev)
    for Ql in (96, 128):
        ql = unit(gen, (8, Ql, d), torch.float32, dev)
        qlm = torch.rand((8, Ql), generator=gen, device=dev) > 0.2
        for dt in (torch.bfloat16, torch.float32):
            dv = docs.to(dt)
            r = scan_route(dv, f"scan Q={Ql} {str(dt)[6:]} [300,100,{d}]")
            errs["maxsim_scan"] = max(errs["maxsim_scan"], max_err(
                KOPS.maxsim_scores(ql, dv, qlm, dm),
                maxsim_ref(ql, qlm, dv, dm),
                f"scan q[8,{Ql},{d}] {str(dt)[6:]} docs ({r} route)", **tol))
        rows = torch.randint(0, 300, (8, 64), generator=gen, device=dev)
        r = scan_route(docs, f"rerank Q={Ql} bf16 [300,100,{d}]",
                       kernel="rerank")
        errs["maxsim_rerank"] = max(errs["maxsim_rerank"], max_err(
            KOPS.maxsim_rerank(ql, docs, rows, qlm, dm),
            KOPS._rerank_ref(ql, docs, rows, qlm.float(), dm),
            f"rerank q[8,{Ql},{d}] rows [8,64] ({r} route)", **tol))
        errs["maxsim_scan"] = max(errs["maxsim_scan"], max_err(
            KOPS.centroid_scores(ql, cents, qlm),
            KOPS.centroid_scores_ref(ql, cents, qlm),
            f"centroid_scores q[8,{Ql},{d}] centroids [64,{d}]", **tol))
    # refused before a launch: a query above the tensor route's token cap,
    # int8 codes that are 8- but not 16-byte aligned
    cap = KOPS.scan_token_cap(torch.bfloat16, d)
    codes, sc = KOPS.quantize_int8(docs)
    buf = torch.empty(codes.numel() + 32, dtype=torch.int8, device=dev)
    off = (8 - buf.data_ptr()) % 16
    shifted = buf[off:off + codes.numel()].view(codes.shape)
    shifted.copy_(codes)
    for what, call in (
            (f"q[1,{cap + 1},{d}] above the token cap",
             lambda: KOPS.maxsim_scores(
                 unit(gen, (1, cap + 1, d), torch.float32, dev), docs,
                 None, dm)),
            ("int8 codes 8 bytes past a 16-byte boundary",
             lambda: KOPS.maxsim_scores(q, shifted, qm, dm, scales=sc))):
        try:
            call()
        except ValueError as e:
            log(f"  scan refuses {what}: {e}")
        else:
            fail(f"scan launched {what}")
    del docs, dm, codes, buf, shifted

    # --- rerank: onto initial (L=prefetch) and mean_pooling (L=k0)
    for name, D, L in (("initial", cfg.n_patches, 256),
                       ("mean_pooling", cfg.n_pooled, 1024)):
        docs = unit(gen, (N, D, d), torch.bfloat16, dev)
        dm = torch.rand((N, D), generator=gen, device=dev) > 0.05
        dm[7] = False                                # fully masked candidate
        rows = torch.randint(0, N, (B, L), generator=gen, device=dev)
        rows[:, 0] = 7
        ok = torch.rand((B, L), generator=gen, device=dev) > 0.1
        scan_route(docs, f"rerank bf16 {name} [{N},{D},{d}]",
                   kernel="rerank")
        scan_route(docs[..., :64], f"rerank bf16 {name} d=64 prefix",
                   kernel="rerank")
        got = KOPS.maxsim_rerank(q, docs, rows, qm, dm, ok)
        want = KOPS._rerank_ref(q, docs, rows, qm.float(), dm)
        want = want.masked_fill(~ok, NEG)
        errs["maxsim_rerank"] = max(errs["maxsim_rerank"], max_err(got, want, f"rerank bf16 {name} rows [{B},{L}] ok-mask",
            **tol))
        live = ok[:, 0]
        check(bool(torch.allclose(got[live, 0], torch.full_like(
            got[live, 0], Qv * NEG))),
              "rerank: a fully masked candidate must score Qv*NEG")
        raw = KOPS.maxsim_rerank(q[:, :, :64], docs[..., :64].contiguous(),
                                 rows, qm, None)
        want = KOPS._rerank_ref(q[:, :, :64], docs[..., :64].contiguous(),
                                rows, qm.float(), None)
        errs["maxsim_rerank"] = max(errs["maxsim_rerank"], max_err(raw, want, f"rerank {name} d=64 broadcast mask", **tol))
        del docs, dm
    # fully masked candidate: Qv*NEG, no NEG/2 floor; Matryoshka prefix;
    # ragged D; clipped rows (-1 and N, which the wrapper clips); f32
    # documents (warp route) and bf16 ones (tensor route); a query with
    # no token
    base = unit(gen, (300, 45, 32), torch.float32, dev)
    dm = torch.ones((300, 45), dtype=torch.bool, device=dev)
    dm[5] = False
    rows = torch.randint(0, 300, (B, 9), generator=gen, device=dev)
    rows[:, 1] = 5
    rows[0, 2], rows[3, 4] = -1, 300
    qz = qm.clone()
    qz[2] = False
    for dt in (torch.float32, torch.bfloat16):
        docs = base.to(dt)
        r = scan_route(docs, f"rerank {str(dt)[6:]} [300,45,32]",
                       kernel="rerank")
        got = KOPS.maxsim_rerank(q, docs, rows, qz, dm)
        want = KOPS._rerank_ref(q[..., :32], docs, rows.clamp(0, 299),
                                qz.float(), dm)
        live = qz.any(-1)
        check(bool(torch.allclose(got[live, 1], torch.full_like(
            got[live, 1], Qv * NEG))),
              "rerank: a fully masked candidate must score Qv*NEG")
        check(bool((got[2] == 0).all()),
              "rerank: a query with no token must score 0")
        errs["maxsim_rerank"] = max(errs["maxsim_rerank"], max_err(
            got, want, f"rerank {str(dt)[6:]} Matryoshka q[..., :32] ragged "
            f"D=45, clipped rows ({r} route)", **tol))

    # --- pooling: a batch of 256 ColPali pages, P [34, 1024]
    pm = torch.from_numpy(POPS.pooling_matrix_static(cfg)[0]).to(dev)
    S_full = cfg.seq_len
    x_full = unit(gen, (256, S_full, d), torch.float32, dev)
    m_full = torch.rand((256, S_full), generator=gen, device=dev) > 0.02
    x = x_full[:, S_full - cfg.n_patches:]           # strided, in place
    m = m_full[:, S_full - cfg.n_patches:]
    got = POPS.pool_pages_fused(x, m, pm)
    want = POPS.pool_ref(x, m, pm)
    errs["pooling"] = max_err(got, want,
                              "pool [256,1024,128] strided, P [34,1024]",
                              rtol=1e-5, atol=1e-5)
    # a dense P with more rows than one pass holds, ragged S, no renorm
    pd = torch.rand((70, 1021), generator=gen, device=dev)
    xr, mr = x_full[:40, :1021], m_full[:40, :1021]
    errs["pooling"] = max(errs["pooling"], max_err(
        POPS.pool_pages_fused(xr, mr, pd, l2_norm=False),
        POPS.pool_ref(xr, mr, pd, l2_norm=False),
        "pool [40,1021,128] dense P [70,1021] no renorm", rtol=1e-5,
        atol=1e-5))

    # --- IVF routing: the scan kernel on K one-vector f32 documents
    cents = torch.randn((64, d), generator=gen, device=dev)
    for dc in (d, 64):
        c = cents[:, :dc].contiguous()
        scan_route(c[:, None, :], f"centroid_scores [64,1,{dc}] f32")
        got = KOPS.centroid_scores(q, c, qm)
        want = KOPS.centroid_scores_ref(q, c, qm)
        errs["maxsim_scan"] = max(errs["maxsim_scan"], max_err(
            got, want, f"centroid_scores q[{B},{Q},{d}] centroids "
            f"[64,{dc}] (scan kernel, D=1 f32)", **tol))
    torch.cuda.synchronize()
    return errs


def check_int8_and_db_kernels(args, dev) -> dict:
    """The double-buffered scan (bf16, int8, f32), the int8 scan and the
    int8 rerank against their plain versions at the main path's shapes,
    and ``quantize_int8`` on the card against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.kernels.maxsim import ops as KOPS

    cfg = get_config("colpali")
    gen = torch.Generator(device=dev).manual_seed(4321)
    B, Q, Qv, d = args.batch, 16, 10, cfg.out_dim
    N = args.pages - 3                       # no multiple of the chunk
    chunk = 256
    q = unit(gen, (B, Q, d), torch.float32, dev)
    qm = torch.zeros((B, Q), dtype=torch.bool, device=dev)
    qm[:, :Qv] = True
    tol = dict(rtol=1e-5, atol=1e-4)
    errs = {"maxsim_scan_db": 0.0, "maxsim_scan_int8": 0.0,
            "maxsim_rerank_int8": 0.0}

    def note(name, err):
        errs[name] = max(errs[name], err)

    # --- quantize_int8: the card's codes and scales are the CPU's
    x = unit(gen, (256, cfg.n_patches, d), torch.bfloat16, dev)
    c_gpu, s_gpu = KOPS.quantize_int8(x)
    c_cpu, s_cpu = KOPS.quantize_int8(x.cpu())
    check(bool((c_gpu.cpu() == c_cpu).all()),
          "quantize_int8: codes on the card differ from the CPU's")
    check(bool((s_gpu.cpu().view(torch.int32)
                == s_cpu.view(torch.int32)).all()),
          "quantize_int8: scales on the card differ from the CPU's")
    log(f"  quantize_int8 [256,{cfg.n_patches},{d}] bf16: card == CPU bit "
        "for bit (codes and scales)")
    del x, c_gpu, s_gpu

    # --- double-buffered scan and int8 scan, mean_pooling and initial
    for name, D in (("mean_pooling", cfg.n_pooled),
                    ("initial", cfg.n_patches)):
        docs = unit(gen, (N, D, d), torch.bfloat16, dev)
        codes, scales = KOPS.quantize_int8(docs)
        dm = torch.rand((N, D), generator=gen, device=dev) > 0.05
        dm[3] = False                                # a fully masked doc
        valid = torch.rand((N,), generator=gen, device=dev) > 0.1
        for what, dv, sc in (("bf16", docs, None), ("int8", codes, scales)):
            scan_route(dv, f"db scan {what} {name} [{N},{D},{d}]",
                       kernel="db scan")
            DSP.reset_counts()
            got = KOPS.maxsim_scores_chunked(q, dv, qm, dm, valid,
                                             chunk=chunk, scales=sc)
            check(DSP.launch_count("maxsim_scan_db") == 1
                  and sum(DSP.launch_count(k) for k in DSP.KERNELS) == 1,
                  "a chunked scan on the card must be one db launch")
            want = KOPS.maxsim_chunked_ref(q, dv, qm, dm, valid,
                                           chunk=chunk, scales=sc)
            note("maxsim_scan_db", max_err(
                got, want, f"db scan {what} {name} [{N},{D},{d}] chunk "
                f"{chunk} doc_valid", **tol))
            check(bool((got[:, 3] < -1e20).all()),
                  "db scan: a fully masked doc must sink")
            del got, want
        # the int8 scan at the streamed top-k's chunk shape and whole
        scan_route(codes, f"scan int8 {name} [{N},{D},{d}]")
        for lo, hi in ((0, chunk), (0, N)):
            got = KOPS.maxsim_scores(q, codes[lo:hi], qm, dm[lo:hi],
                                     valid[lo:hi], scales=scales[lo:hi])
            want = KOPS.maxsim_chunked_ref(q, codes[lo:hi], qm, dm[lo:hi],
                                           valid[lo:hi], chunk=chunk,
                                           scales=scales[lo:hi])
            note("maxsim_scan_int8", max_err(
                got, want, f"scan int8 {name} [{hi - lo},{D},{d}] "
                "doc_valid", **tol))
        # broadcast [1, D] mask through the db scan
        row = dm[:1].clone()
        for what, dv, sc in (("bf16", docs, None), ("int8", codes, scales)):
            got = KOPS.maxsim_scores_chunked(q, dv, qm, row, None,
                                             chunk=chunk, scales=sc)
            want = KOPS.maxsim_chunked_ref(q, dv, qm, row, None, chunk=chunk,
                                           scales=sc)
            note("maxsim_scan_db", max_err(
                got, want, f"db scan {what} {name} broadcast [1,{D}] mask",
                **tol))
        del docs, codes, scales, dm, got, want
    # ragged N, D and Q, broadcast (absent) mask: f32 docs (warp route),
    # bf16 docs and int8 codes (tensor route, tiles across documents)
    q7 = q[:5, :7].contiguous()
    x = unit(gen, (1001, 37, d), torch.float32, dev)
    c7, s7 = KOPS.quantize_int8(x)
    for what, dv, sc in (("f32", x, None), ("bf16", x.to(torch.bfloat16),
                                            None), ("int8", c7, s7)):
        r = scan_route(dv, f"db scan {what} [1001,37,{d}]", kernel="db scan")
        got = KOPS.maxsim_scores_chunked(q7, dv, None, None, chunk=100,
                                         scales=sc)
        want = KOPS.maxsim_chunked_ref(q7, dv, None, None, chunk=100,
                                       scales=sc)
        note("maxsim_scan_db", max_err(
            got, want, f"db scan {what} ragged q[5,7] [1001,37] no mask "
            f"({r} route)", **tol))
    # long queries (Q = 96 and 128 at d = 128) through the db scan
    docs = unit(gen, (300, 100, d), torch.bfloat16, dev)
    dm = torch.rand((300, 100), generator=gen, device=dev) > 0.05
    for Ql in (96, 128):
        ql = unit(gen, (8, Ql, d), torch.float32, dev)
        qlm = torch.rand((8, Ql), generator=gen, device=dev) > 0.2
        r = scan_route(docs, f"db scan Q={Ql} bf16 [300,100,{d}]",
                       kernel="db scan")
        note("maxsim_scan_db", max_err(
            KOPS.maxsim_scores_chunked(ql, docs, qlm, dm, chunk=64),
            KOPS.maxsim_chunked_ref(ql, docs, qlm, dm, chunk=64),
            f"db scan q[8,{Ql},{d}] bf16 [300,100] ({r} route)", **tol))
    del c7, s7, dm

    # --- int8 rerank: onto initial (L=prefetch) and mean_pooling (L=k0)
    for name, D, L in (("initial", cfg.n_patches, 256),
                       ("mean_pooling", cfg.n_pooled, 1024)):
        codes, scales = KOPS.quantize_int8(
            unit(gen, (N, D, d), torch.bfloat16, dev))
        dm = torch.rand((N, D), generator=gen, device=dev) > 0.05
        dm[7] = False                                # fully masked candidate
        rows = torch.randint(0, N, (B, L), generator=gen, device=dev)
        rows[:, 0] = 7
        ok = torch.rand((B, L), generator=gen, device=dev) > 0.1
        scan_route(codes, f"rerank int8 {name} [{N},{D},{d}]",
                   kernel="rerank")
        got = KOPS.maxsim_rerank(q, codes, rows, qm, dm, ok, scales=scales)
        want = KOPS._rerank_ref(q, codes, rows, qm.float(), dm, scales)
        live = ok[:, 0]
        check(bool(torch.allclose(got[live, 0], torch.full_like(
            got[live, 0], Qv * NEG))),
              "int8 rerank: a fully masked candidate must score Qv*NEG")
        want = want.masked_fill(~ok, NEG)
        note("maxsim_rerank_int8", max_err(
            got, want, f"rerank int8 {name} rows [{B},{L}] ok-mask", **tol))
        row = dm[:1].clone()
        got = KOPS.maxsim_rerank(q[..., :64], codes[..., :64].contiguous(),
                                 rows, qm, row,
                                 scales=scales)
        want = KOPS._rerank_ref(q[..., :64], codes[..., :64].contiguous(),
                                rows, qm.float(), row, scales)
        note("maxsim_rerank_int8", max_err(
            got, want, f"rerank int8 {name} d=64 broadcast [1,{D}] mask",
            **tol))
        del codes, scales, dm
    # int8 Matryoshka prefix, ragged D = 45, a fully masked candidate,
    # clipped rows (tensor route)
    codes, scales = KOPS.quantize_int8(unit(gen, (300, 45, 32),
                                            torch.float32, dev))
    dm = torch.ones((300, 45), dtype=torch.bool, device=dev)
    dm[5] = False
    rows = torch.randint(0, 300, (B, 9), generator=gen, device=dev)
    rows[:, 1] = 5
    rows[0, 2], rows[3, 4] = -1, 300
    r = scan_route(codes, "rerank int8 [300,45,32]", kernel="rerank")
    got = KOPS.maxsim_rerank(q, codes, rows, qm, dm, scales=scales)
    want = KOPS._rerank_ref(q[..., :32], codes, rows.clamp(0, 299),
                            qm.float(), dm, scales)
    check(bool(torch.allclose(got[:, 1], torch.full_like(got[:, 1],
                                                         Qv * NEG))),
          "int8 rerank: a fully masked candidate must score Qv*NEG")
    note("maxsim_rerank_int8", max_err(
        got, want, f"rerank int8 Matryoshka q[..., :32] ragged D=45, clipped "
        f"rows ({r} route)", **tol))
    del codes, scales, dm

    # --- an empty query batch or corpus launches nothing and counts nothing
    DSP.reset_counts()
    codes, scales = KOPS.quantize_int8(unit(gen, (0, 8, d), torch.bfloat16,
                                            dev))
    KOPS.maxsim_scores(q, codes, scales=scales)
    KOPS.maxsim_scores_pipelined(q, codes, chunk=chunk, scales=scales)
    for dv in (x, docs):                       # warp and tensor routes
        KOPS.maxsim_scores_pipelined(q[:0], dv, chunk=chunk)
        KOPS.maxsim_rerank(q[:0], dv, rows[:0])
    torch.cuda.synchronize()
    check(all(DSP.launch_count(k) == 0 for k in DSP.KERNELS),
          "an empty scan or rerank counted a launch")
    log("  empty query batch / corpus: no launch counted")
    return errs


# ---------------------------------------------------------------------------
# phase 3b: embed_bag
# ---------------------------------------------------------------------------

def embed_bag_phase(args, dev) -> dict:
    """``embed_bag`` at its three shapes: against its plain version, the
    op's own run (counts zeroed before it, read after it) and times. The
    Criteo-size table is made on the card and freed at the end."""
    import torch.nn.functional as F
    from repro_torch.configs import CRITEO_TB_VOCABS
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.kernels.embed_bag import embed_bag, embed_bag_ref
    from repro_torch.kernels.embed_bag import ops as EOPS

    gen = torch.Generator(device=dev).manual_seed(2024)
    tol = dict(rtol=1e-5, atol=1e-5)
    shapes = (("kernel_micro f32", 100_000, 64, torch.float32, 4096, 8),
              ("kernel_micro bf16", 100_000, 64, torch.bfloat16, 4096, 8),
              ("criteo-1TB largest field f32", max(CRITEO_TB_VOCABS), 128,
               torch.float32, 16_384, 100))
    log(f"[embed_bag] tolerance rtol={tol['rtol']}, atol={tol['atol']} "
        "(f32 sums over L in another order)")
    err, launches, rows = 0.0, 0, []
    for what, V, d, dtype, B, L in shapes:
        t0 = time.perf_counter()
        table = torch.randn((V, d), generator=gen, device=dev).to(dtype)
        idx = torch.randint(0, V, (B, L), generator=gen, device=dev)
        idx[torch.rand((B, L), generator=gen, device=dev) < 0.2] = -1
        valid = torch.rand((B, L), generator=gen, device=dev) > 0.1
        torch.cuda.synchronize()
        gb = table.numel() * table.element_size() / 1e9
        # the op as a user calls it: counts zeroed before, read after
        DSP.reset_counts()
        out = embed_bag(table, idx, mode="sum")
        torch.cuda.synchronize()
        n = DSP.launch_count("embed_bag")
        check(n == 1 and sum(DSP.launch_count(k) for k in DSP.KERNELS) == 1,
              f"embed_bag {what}: one op call must be one embed_bag launch")
        check(bool(torch.isfinite(out).all()) and out.shape == (B, d),
              f"embed_bag {what}: output not finite [{B},{d}]")
        launches += n
        # against the plain version: both modes, with and without valid
        for mode in ("sum", "mean"):
            for vv in (None, valid):
                got = embed_bag(table, idx, vv, mode=mode)
                w = ((idx >= 0) if vv is None else vv).float()
                if mode == "mean":
                    w = w / w.sum(-1, keepdim=True).clamp_min(1.0)
                want = embed_bag_ref(table, idx.clamp(0, V - 1), w)
                err = max(err, max_err(got, want, f"embed_bag {what} "
                          f"[{V},{d}] bags [{B},{L}] {mode}"
                          + (" valid" if vv is not None else ""), **tol))
                del got, want
        # times: the kernel's launch alone, the op (with its mask and
        # weight set-up), the plain version and one library call
        w = (idx >= 0).float()
        i32 = idx.clamp(0, V - 1).to(torch.int32)
        ms = time_ms(lambda: EOPS._embed_bag_cuda(table, i32, w))
        op_ms = time_ms(lambda: embed_bag(table, idx))
        plain = time_ms(lambda: embed_bag_ref(table, i32, w), iters=3)
        wl = w.to(dtype)
        try:
            lib = time_ms(lambda: F.embedding_bag(
                i32, table, per_sample_weights=wl, mode="sum"), iters=3)
        except RuntimeError as e:         # the yardstick only, not the port
            log(f"  F.embedding_bag refused {what}: {e}")
            lib = None
        # bound: the rows this data needs (the distinct ids of every
        # slot: a zero-weight slot reads its clipped row too, as in the
        # reference), the ids and weights, the output
        need = torch.unique(i32).numel()
        nbytes = (need * d * table.element_size() + B * L * 8 + B * d * 4)
        flops = 2.0 * int((w != 0).sum()) * d
        b_ms, b_by = bound(nbytes, flops)
        log(f"[times] embed_bag {what} table [{V},{d}] {gb:.2f} GB (made "
            f"in {time.perf_counter() - t0:.1f}s), bags [{B},{L}] "
            f"({need} distinct rows): kernel {ms:.4f} ms, "
            f"op {op_ms:.4f} ms, plain {plain:.4f} ms, library "
            f"(F.embedding_bag, per_sample_weights, {str(dtype)[6:]} out) "
            f"{lib} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{nbytes / ms / 1e6:.1f} GB/s achieved, kernel at "
            f"{100 * b_ms / ms:.1f}% of the bound")
        rows.append(dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib, shape=f"[{V},{d}] bags [{B},{L}]"))
        del table, idx, valid, out, w, i32, wl
        torch.cuda.empty_cache()
    # non-finite rows under zero-weight slots: -1 padding clips to row 0
    # (inf, -inf, NaN) and masked-out slots point at row 7 (inf); every
    # slot adds w * row as in the reference, so 0 * inf makes those bags'
    # columns NaN, in the plain version's places
    for dtype in (torch.float32, torch.bfloat16):
        V, d, B, L = 100_000, 64, 4096, 8
        table = torch.randn((V, d), generator=gen, device=dev)
        table[0, :3] = torch.tensor([float("inf"), -float("inf"),
                                     float("nan")], device=dev)
        table[7, 3] = float("inf")
        table = table.to(dtype)
        idx = torch.randint(1, V, (B, L), generator=gen, device=dev)
        idx[torch.rand((B, L), generator=gen, device=dev) < 0.2] = -1
        idx[::3, 2] = 7
        valid = idx >= 0
        valid[::3, 2] = False
        for vv in (None, valid):
            got = embed_bag(table, idx, vv)
            w = ((idx >= 0) if vv is None else vv).float()
            want = embed_bag_ref(table, idx.clamp(0, V - 1), w)
            nan = torch.isnan(want)
            check(bool(nan.any()) and bool(torch.equal(torch.isnan(got),
                                                       nan)),
                  f"embed_bag {str(dtype)[6:]}: NaN pattern under zero-weight "
                  "slots differs from the plain version's")
            try:
                torch.testing.assert_close(got, want, equal_nan=True, **tol)
            except AssertionError as e:
                fail(f"embed_bag non-finite rows: kernel != plain: {e}")
            log(f"  embed_bag {str(dtype)[6:]} [{V},{d}] bags [{B},{L}] with "
                "inf/NaN rows under padded"
                + (" and masked-out" if vv is not None else "")
                + f" slots: {int(nan.sum())} NaN, the plain version's "
                "places; the rest ok")
    return dict(entry=dict(
        name="embed_bag", route="cuda",
        source="src/repro_torch/csrc/embed_bag.cu",
        replaces="src/repro/kernels/embed_bag/embed_bag.py:36",
        launches=launches, max_abs_err=err, **rows[-1]))


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def run_cascade(retriever, bench, stages, batch: int,
                filter=None) -> tuple:
    """All queries through ``stages`` in batches: (ids [Nq, k], scores
    [Nq, k], seconds of the timed batches, queries timed). The first batch
    is run once untimed first, to warm the allocator."""
    q, qm = bench.queries, bench.query_mask
    retriever.search(q[:batch], qm[:batch], stages=stages, filter=filter)
    torch.cuda.synchronize()
    ids, scores = [], []
    t0 = time.perf_counter()
    for i in range(0, len(q), batch):
        s, ix = retriever.search(q[i:i + batch], qm[i:i + batch],
                                 stages=stages, filter=filter)
        scores.append(s)
        ids.append(ix)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return (np.concatenate(ids), torch.cat(scores).float().cpu().numpy(),
            dt, len(q))


def plus_one(stages) -> tuple:
    """``stages`` with the last stage's k one higher: the plain ranking
    that ``compare_rankings`` holds a kernel's top k against."""
    last = stages[-1]
    return tuple(stages[:-1]) + (dataclasses.replace(last, k=last.k + 1),)


def compare_rankings(ids_k, sc_k, ids_p, sc_p, what: str,
                     tie: float = 1e-4) -> int:
    """Kernel top-k [n, k] vs the plain ranking one deeper [n, k + 1]
    (``plus_one``): ids equal except where the plain scores hold a tie
    within ``tie`` at that position (0: exact ties only), a tie of the
    k-th with the (k+1)-th plain score included; scores allclose to the
    plain top k. Returns the number of tie-swapped positions."""
    n, k = ids_k.shape
    check(ids_p.shape == (n, k + 1) and sc_p.shape == (n, k + 1),
          f"{what}: the plain ranking has shape {ids_p.shape}, not one "
          f"deeper than the kernel's {ids_k.shape}")
    check(np.isfinite(sc_k).all() and np.isfinite(sc_p).all(),
          f"{what}: non-finite scores")
    check(np.allclose(sc_k, sc_p[:, :k], rtol=1e-5, atol=1e-4),
          f"{what}: scores differ beyond rtol=1e-5, atol=1e-4 "
          f"(max {np.abs(sc_k - sc_p[:, :k]).max():.3e})")
    swaps = 0
    for r in range(n):
        m, j = row_swaps(ids_k[r], ids_p[r, :k], sc_p[r], tie)
        if j is not None:
            fail(f"{what}: query {r} rank {j} id {ids_k[r, j]} != "
                 f"{ids_p[r, j]} without a tie")
        swaps += m
    return swaps


def row_swaps(ids_k, ids_p, sc_p, tie: float) -> tuple:
    """(positions where one query's kernel and plain ids differ, the first
    such position whose plain score holds no tie within ``tie`` with a
    neighbour, or None). The neighbours are those in ``sc_p``: with one
    plain score more than ids, a tie of the k-th with the (k+1)-th is
    seen."""
    swaps = 0
    for j in np.flatnonzero(ids_k != ids_p):
        near = [abs(sc_p[j] - sc_p[jj]) <= tie
                for jj in (j - 1, j + 1) if 0 <= jj < len(sc_p)]
        if not any(near):
            return swaps, int(j)
        swaps += 1
    return swaps, None


def compare_two_stage(store, doc_ids, search, kern, q, qm, ids_k, sc_k,
                      ids_p, sc_p, what: str, tie: float = 1e-4) -> tuple:
    """``compare_rankings`` for a 2-stage cascade over a corpus whose
    stage-0 scores crowd at the prefetch cutoff, where the scan's own
    tolerance (rtol 1e-5, atol 1e-4) can put a different document among
    the candidates. ``store`` is one raw store dict, ``doc_ids`` maps its
    slots to the ids in ``ids_k``, and ``search(q, qm, stages)`` runs the
    kernel cascade over it to (scores, slot ids). The plain ranking
    ``ids_p``/``sc_p`` has k or, from ``plus_one``, k + 1 columns. A query
    whose kernel and plain ids differ beyond final-score ties passes only
    if (i) its kernel and plain stage-0 candidate sets differ only in
    documents whose plain stage-0 score (the scan chunked by 256 pages,
    int8 where the kernel's is) lies within twice that tolerance of the
    plain cutoff score, and (ii) its kernel ids and scores are the plain
    top-k over the kernel's own candidates, apart from final-score ties, a
    tie of the k-th with the (k+1)-th plain score included. Returns (tie
    swaps, queries explained by cutoff ties)."""
    from repro_torch.core import multistage as MST
    from repro_torch.retrieval.engine import make_search_fn
    from repro_torch.retrieval.store import ROUTING_KEYS
    n, k = ids_k.shape
    check(ids_p.shape[0] == n and ids_p.shape[1] in (k, k + 1),
          f"{what}: plain ids {ids_p.shape} against kernel ids {ids_k.shape}")
    check(np.isfinite(sc_k).all() and np.isfinite(sc_p).all(),
          f"{what}: non-finite scores")
    swaps, bad = 0, []
    for i in range(n):
        m, j = row_swaps(ids_k[i], ids_p[i, :k], sc_p[i], tie)
        if j is not None:
            bad.append(i)
            continue
        check(np.allclose(sc_k[i], sc_p[i, :k], rtol=1e-5, atol=1e-4),
              f"{what}: query {i} scores differ beyond rtol=1e-5, atol=1e-4")
        swaps += m
    if not bad:
        return swaps, 0
    n_slots = int(store[kern[0].vector].shape[0])
    q, qm = q[bad], qm[bad]
    _, c0 = search(q, qm, kern[:1])
    fs, fk = search(q, qm, kern)
    first = dataclasses.replace(MST.with_scan_policy(
        kern[:1], use_kernel=False, chunk=256)[0], k=n_slots)
    s_all, c_all = make_search_fn((first,), n_slots)(store, q, qm)
    k0 = kern[0].k
    for b, i in enumerate(bad):
        cut = float(s_all[b, k0 - 1])
        tol = 2 * (1e-4 + 1e-5 * abs(cut))
        plain0 = dict(zip(c_all[b].tolist(), s_all[b].float().tolist()))
        diff = set(c_all[b, :k0].tolist()) ^ set(c0[b].tolist())
        far = [d for d in diff if abs(plain0[d] - cut) > tol]
        check(not far, f"{what}: query {i}: stage-0 candidates {far} differ "
              f"from the plain path's {abs(plain0[far[0]] - cut) if far else 0:.3e}"
              f" from the cutoff score {cut:.6f} (tolerance {tol:.1e})")
        check(np.array_equal(doc_ids[fk[b].cpu().numpy()], ids_k[i])
              and np.array_equal(fs[b].float().cpu().numpy(), sc_k[i]),
              f"{what}: query {i}: a second kernel search gave other ids "
              "or scores")
        cand = c0[b]
        sub = {key: v[cand] for key, v in store.items()
               if key not in ROUTING_KEYS}
        # the whole plain ranking of the candidates, so that a tie between
        # the k-th and the (k+1)-th is seen
        whole = (dataclasses.replace(kern[1], k=len(cand)),)
        ps, pi = MST.search(sub, q[b:b + 1], whole, qm[b:b + 1])
        want_s = ps[0].float().cpu().numpy()
        _, j = row_swaps(fk[b].cpu().numpy(), cand[pi[0, :k]].cpu().numpy(),
                         want_s, tie)
        check(j is None, f"{what}: query {i} rank {j}: kernel ids are not "
              "the plain top-k over the kernel's own candidates")
        check(np.allclose(fs[b].float().cpu().numpy(), want_s[:k],
                          rtol=1e-5, atol=1e-4), f"{what}: query {i}: "
              "kernel scores differ from the plain ones over its candidates")
    return swaps, len(bad)


def main_path(args, dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import multistage as MST
    from repro_torch.data.synthetic import evaluate_ranking, make_benchmark
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.retrieval.ingest import IngestPipeline
    from repro_torch.retrieval.retriever import Retriever
    from repro_torch.retrieval.segments import bucket_capacity

    cfg = get_config("colpali")
    n0 = args.pages * 3 // 8
    per_ds = (n0, (args.pages - n0) // 2, args.pages - n0 - (args.pages - n0) // 2)
    q_ds = (args.queries // 3,) * 2 + (args.queries - 2 * (args.queries // 3),)
    t0 = time.perf_counter()
    bench = make_benchmark(cfg, n_pages_per_ds=per_ds, queries_per_ds=q_ds,
                           seed=0)
    log(f"[main] data: {bench.pages.shape[0]} pages x {bench.pages.shape[1]} "
        f"tokens x d={bench.pages.shape[2]}, {len(bench.queries)} queries "
        f"(n_pages_per_ds={per_ds}) in {time.perf_counter() - t0:.1f}s")

    DSP.reset_counts()
    # ---- index through the pooling kernel, 256 pages per batch
    t0 = time.perf_counter()
    pipe = IngestPipeline(cfg, device=dev)
    step = 256
    first = pipe.index(bench.pages[:step], bench.token_types)
    retriever = Retriever(first, capacity=bucket_capacity(args.pages),
                          device=dev)
    for i in range(step, len(bench.pages), step):
        retriever.upsert(pipe.index(bench.pages[i:i + step],
                                    bench.token_types))
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t0
    init = retriever.store.vectors["initial"]
    log(f"[main] indexed {retriever.n_docs} pages in {t_index:.1f}s "
        f"({retriever.n_docs / t_index:.0f} pages/s incl. host->device); "
        f"initial {tuple(init.shape)} {init.dtype} = "
        f"{init.numel() * init.element_size() / 1e9:.2f} GB on the card")

    log(f"[main] pooling launches while indexing: "
        f"{DSP.launch_count('pooling')} (one per 256-page batch)")

    cascades = {1: MST.one_stage(10), 2: MST.two_stage(256, 10),
                3: MST.three_stage(1024, 256, 10)}
    results = {}
    for n, stages in cascades.items():
        st = MST.with_rerank_policy(MST.with_scan_policy(
            stages, use_kernel=True), rerank_kernel=True)
        before = {k: DSP.launch_count(k) for k in DSP.KERNELS}
        ids, sc, dt, nq = run_cascade(retriever, bench, st,
                                      args.batch)
        calls = 1 + -(-nq // args.batch)            # warm-up + batches
        per_call = {k: (DSP.launch_count(k) - before[k]) / calls
                    for k in ("maxsim_scan", "maxsim_rerank")}
        m = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
        results[n] = dict(ids=ids, scores=sc, qps=nq / dt, metrics=m,
                          per_call=per_call,
                          ms_batch=1e3 * dt / -(-nq // args.batch))
        log(f"[main] {n}-stage kernels: QPS={nq / dt:.1f} (batch "
            f"{args.batch}) " + "  ".join(f"{k}={v:.4f}"
                                          for k, v in m.items())
            + f"; launches per query batch {per_call}")
    counts = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    log(f"[main] kernel launches over the main path: {counts}")
    for k in ("maxsim_scan", "maxsim_rerank", "pooling"):
        check(counts[k] > 0, f"kernel {k} was never launched on the main "
              "path")

    # ---- the same cascades through the plain path on the card
    DSP.reset_counts()
    for n, stages in cascades.items():
        st = MST.with_scan_policy(plus_one(stages), use_kernel=False,
                                  chunk=256)
        ids, sc, dt, nq = run_cascade(retriever, bench, st,
                                      args.batch)
        m = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
        log(f"[main] {n}-stage plain:   QPS={nq / dt:.1f} "
            + "  ".join(f"{k}={v:.4f}" for k, v in m.items()))
        res = results[n]
        swaps = compare_rankings(res["ids"], res["scores"], ids, sc,
                                 f"{n}-stage kernel vs plain")
        for k in m:
            check(abs(m[k] - res["metrics"][k]) < 5e-4,
                  f"{n}-stage {k}: kernel {res['metrics'][k]:.4f} != "
                  f"plain {m[k]:.4f} to 3 decimals")
        res["plain_qps"] = nq / dt
        log(f"[main] {n}-stage: kernel == plain top-10 ids "
            f"({swaps} tie swaps), metrics equal to 3 decimals")
        check(all(DSP.launch_count(k) == 0 for k in DSP.KERNELS),
              "the plain path launched a kernel")
        # the plain engine against the cascade oracle, one query batch
        qb = torch.as_tensor(bench.queries[:args.batch]).to(dev)
        mb = torch.as_tensor(bench.query_mask[:args.batch]).to(dev)
        o_s, o_i = MST.search(retriever.store.vectors, qb, plus_one(stages),
                              mb)
        e_s, e_i = retriever.search(
            qb, mb, stages=MST.with_scan_policy(stages, use_kernel=False,
                                                chunk=256),
            translate_ids=False)
        compare_rankings(e_i.cpu().numpy(), e_s.cpu().numpy(),
                         o_i.cpu().numpy(), o_s.cpu().numpy(),
                         f"{n}-stage engine vs multistage.search oracle")
    return dict(results=results, counts=counts, retriever=retriever,
                bench=bench)


def device_gb(vectors: dict) -> float:
    return sum(v.numel() * v.element_size() for v in vectors.values()) / 1e9


def index_int8(args, dev, bench, name: str, stages):
    """Index the corpus as ``serve.py --int8`` does: ``IngestPipeline``
    pools and quantises each 256-page batch (the scan vector's float copy
    dropped when no later stage reranks on it) and ``Retriever.upsert``
    adds the quantised batches."""
    from repro_torch.configs import get_config
    from repro_torch.retrieval.ingest import IngestPipeline
    from repro_torch.retrieval.retriever import Retriever
    from repro_torch.retrieval.segments import bucket_capacity

    pipe = IngestPipeline(get_config("colpali"), quantize=(name,),
                          stages=stages, device=dev)
    step = 256
    r = Retriever(pipe.index(bench.pages[:step], bench.token_types),
                  capacity=bucket_capacity(args.pages), device=dev)
    for i in range(step, len(bench.pages), step):
        r.upsert(pipe.index(bench.pages[i:i + step], bench.token_types))
    return r


def main_path_int8(args, dev, main) -> dict:
    """The int8 store with the chunked (double-buffered) and streamed
    scans over the phase-4 corpus, indexed through the quantising ingest."""
    from repro_torch.core import multistage as MST
    from repro_torch.data.synthetic import evaluate_ranking
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.retrieval.store import (VectorStore, is_store_companion,
                                             quantize_store)

    bench, base_r = main["bench"], main["retriever"]
    n = base_r.n_docs
    base = VectorStore({k: v[:n] for k, v in base_r.store.vectors.items()
                        if not is_store_companion(k)}, n)
    one, two = MST.one_stage(10), MST.two_stage(256, 10)
    DSP.reset_counts()
    t0 = time.perf_counter()
    ra = index_int8(args, dev, bench, "initial", one)       # initial codes
    rb = index_int8(args, dev, bench, "mean_pooling", two)  # pooled codes
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t0
    check(DSP.launch_count("pooling") > 0,
          "the int8 ingest never launched the pooling kernel")
    store_a, store_b = (
        VectorStore({k: v[:n] for k, v in r.store.vectors.items()
                     if not is_store_companion(k)}, n) for r in (ra, rb))
    # per-vector quantisation: the batched ingest's codes and scales are
    # those of the whole float store quantised at once
    for got, name, stages in ((store_a, "initial", one),
                              (store_b, "mean_pooling", two)):
        want = quantize_store(base, (name,), stages)
        check(set(got.vectors) == set(want.vectors),
              f"int8 ingest of {name}: keys {sorted(got.vectors)} != "
              f"{sorted(want.vectors)}")
        for k in (f"{name}_int8", f"{name}_scale"):
            check(bool(torch.equal(got.vectors[k], want.vectors[k])),
                  f"int8 ingest: {k} differs from quantize_store's")
        del want
    log(f"[int8] indexed 2 x {n} pages through the quantising ingest in "
        f"{t_index:.1f}s; codes and scales equal quantize_store's bit for "
        f"bit; device bytes: "
        f"float store {device_gb(base.vectors):.3f} GB, 1-stage int8 store "
        f"{device_gb(store_a.vectors):.3f} GB (initial: bf16 "
        f"{device_gb({'x': base.vectors['initial']}):.3f} GB -> codes + "
        "scales "
        f"{device_gb({k: store_a.vectors[k] for k in ('initial_int8', 'initial_scale')}):.3f}"
        f" GB), 2-stage int8 store {device_gb(store_b.vectors):.3f} GB")
    del store_a, store_b
    cascades = {
        "1-stage int8 initial (db scan)": (ra, one, False),
        "2-stage bf16 pooled (db scan) + int8 rerank": (ra, two, False),
        "1-stage int8 initial scan_topk": (ra, one, True),
        "2-stage int8 pooled (db scan) + bf16 rerank": (rb, two, False),
        "2-stage int8 pooled scan_topk + bf16 rerank": (rb, two, True),
    }
    float_ndcg = {1: main["results"][1]["metrics"]["ndcg@10"],
                  2: main["results"][2]["metrics"]["ndcg@10"]}
    results = {}
    DSP.reset_counts()
    for name, (r, stages, topk) in cascades.items():
        st = MST.with_rerank_policy(MST.with_scan_policy(
            stages, use_kernel=True, chunk=256, scan_topk=topk),
            rerank_kernel=True)
        ids, sc, dt, nq = run_cascade(r, bench, st, args.batch)
        m = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
        results[name] = dict(ids=ids, scores=sc, qps=nq / dt, metrics=m,
                             ms_batch=1e3 * dt / -(-nq // args.batch))
        log(f"[int8] {name}: QPS={nq / dt:.1f} " + "  ".join(
            f"{k}={v:.4f}" for k, v in m.items()) + f"; float "
            f"{len(stages)}-stage ndcg@10={float_ndcg[len(stages)]:.4f}")
    counts = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    log(f"[int8] kernel launches over the int8 path: {counts}")
    for k in ("maxsim_scan_db", "maxsim_scan_int8", "maxsim_rerank",
              "maxsim_rerank_int8"):
        check(counts[k] > 0, f"kernel {k} was never launched on the int8 "
              "path")

    # ---- the same cascades through the plain path on the card
    DSP.reset_counts()
    qb = torch.as_tensor(bench.queries[:args.batch]).to(dev)
    mb = torch.as_tensor(bench.query_mask[:args.batch]).to(dev)
    for name, (r, stages, topk) in cascades.items():
        st = MST.with_scan_policy(plus_one(stages), use_kernel=False,
                                  chunk=256, scan_topk=topk)
        ids, sc, dt, nq = run_cascade(r, bench, st, args.batch)
        m = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
        res = results[name]
        swaps = compare_rankings(res["ids"], res["scores"], ids, sc,
                                 f"{name} kernel vs plain")
        for k in m:
            check(abs(m[k] - res["metrics"][k]) < 5e-4,
                  f"{name} {k}: kernel {res['metrics'][k]:.4f} != plain "
                  f"{m[k]:.4f} to 3 decimals")
        res["plain_qps"] = nq / dt
        log(f"[int8] {name} plain: QPS={nq / dt:.1f}; kernel == plain "
            f"top-10 ids ({swaps} tie swaps), metrics equal to 3 decimals")
        if len(stages) == 2 and not topk:
            o_s, o_i = MST.search(r.store.vectors, qb, plus_one(stages), mb)
            e_s, e_i = r.search(
                qb, mb, stages=MST.with_scan_policy(stages, use_kernel=False,
                                                    chunk=256),
                translate_ids=False)
            compare_rankings(e_i.cpu().numpy(), e_s.cpu().numpy(),
                             o_i.cpu().numpy(), o_s.cpu().numpy(),
                             f"{name} engine vs multistage.search oracle")
    check(all(DSP.launch_count(k) == 0 for k in DSP.KERNELS),
          "the plain int8 path launched a kernel")
    return dict(results=results, counts=counts, ra=ra, rb=rb,
                cascades=cascades)


# ---------------------------------------------------------------------------
# phase 4c: tenant and tag filters
# ---------------------------------------------------------------------------

def base_store(main):
    """The phase-4 pages as one ``VectorStore`` (views of the store's
    tensors, companions left out)."""
    from repro_torch.retrieval.store import VectorStore, is_store_companion
    r = main["retriever"]
    n = r.n_docs
    return VectorStore({k: v[:n] for k, v in r.store.vectors.items()
                        if not is_store_companion(k)}, n)


def tenant_groups(n: int, group: int = 64, n_tenants: int = 8,
                  n_tags: int = 64):
    """Phase 4c's stamping of ``n`` pages: (lo, hi, tenant, tags) of each
    group of ``group`` pages, 8 of ``n_tags`` tags drawn per group."""
    rng = np.random.default_rng(15)
    for g, lo in enumerate(range(0, n, group)):
        tags = tuple(int(t) for t in rng.choice(n_tags, 8, replace=False))
        yield lo, min(lo + group, n), g % n_tenants, tags


def filtered_path(args, dev, main) -> dict:
    """The phase-4 pages upserted in groups of 64, each group stamped with
    a tenant and 8 of 64 tags; filtered 2-stage searches against the
    rebuilt matching corpus and the plain filtered path. Returns the
    filtered store too (phase 4p holds its mesh twin against it)."""
    from repro_torch.core import multistage as MST
    from repro_torch.data.synthetic import evaluate_ranking
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.retrieval.retriever import Retriever
    from repro_torch.retrieval.segments import bucket_capacity
    from repro_torch.retrieval.store import FilterSpec, VectorStore

    bench = main["bench"]
    base = base_store(main)
    n = base.n_docs
    cap = bucket_capacity(args.pages)
    n_tenants, n_tags, group = 8, 64, 64
    tenant_of = np.zeros(n, np.int64)
    tags_of = np.zeros((n, n_tags), bool)
    empty = VectorStore({k: v[:0] for k, v in base.vectors.items()}, 0)
    t0 = time.perf_counter()
    r = Retriever(empty, capacity=cap, device=dev, filter_words=2)
    for lo, hi, tenant, tags in tenant_groups(n, group, n_tenants, n_tags):
        ids = r.upsert(VectorStore({k: v[lo:hi] for k, v in
                                    base.vectors.items()}, hi - lo),
                       tenant=tenant, tags=tags)
        check(np.array_equal(ids, np.arange(lo, hi)),
              "filtered store: page ids must follow the phase-4 order")
        tenant_of[lo:hi] = tenant
        tags_of[lo:hi, list(tags)] = True
    torch.cuda.synchronize()
    log(f"[filter] upserted {n} pages in groups of {group}, {n_tenants} "
        f"tenants, {n_tags} tags (2 filter words) in "
        f"{time.perf_counter() - t0:.2f}s")
    # a tag that tenant 5 carries on the most pages, and three any-tags
    t5 = tags_of[tenant_of == 5].sum(0)
    req = int(np.argmax(t5))
    specs = (FilterSpec(tenant=3), FilterSpec(tenant=5, require_tags=(req,)),
             FilterSpec(any_tags=(1, 33, 62)))
    two = MST.two_stage(256, 10)
    kern = MST.with_rerank_policy(MST.with_scan_policy(two, use_kernel=True),
                                  rerank_kernel=True)
    plain = MST.with_scan_policy(plus_one(two), use_kernel=False, chunk=256)
    q, qm = bench.queries, bench.query_mask
    results = {}
    DSP.reset_counts()
    for spec in specs:
        match = np.flatnonzero(
            ((spec.tenant < 0) | (tenant_of == spec.tenant))
            & tags_of[:, list(spec.require_tags)].all(1)
            & (tags_of[:, list(spec.any_tags)].any(1) if spec.any_tags
               else True))
        ids, sc, dt, nq = run_cascade(r, bench, kern, args.batch, spec)
        # (a) no id outside the filter
        got = ids[ids >= 0]
        check(np.isin(got, match).all(),
              f"filter {spec}: returned a page outside the filter")
        check(bool((sc[ids < 0] <= NEG / 2).all()),
              f"filter {spec}: a filler id (-1) with a live score")
        # (b) the unfiltered search over the rebuilt matching corpus
        rows = torch.from_numpy(match).to(dev)
        rb = Retriever(VectorStore({k: v.index_select(0, rows) for k, v in
                                    base.vectors.items()}, len(match)),
                       capacity=cap, device=dev)
        ids_b, sc_b, _, _ = run_cascade(rb, bench, plus_one(kern), args.batch)
        ids_b = np.where(ids_b >= 0, match[np.clip(ids_b, 0, None)], -1)
        k = ids.shape[1]
        bitwise = bool(np.array_equal(sc, sc_b[:, :k]))
        if bitwise:
            check(np.array_equal(ids, ids_b[:, :k]), f"filter {spec}: scores "
                  "equal bit for bit but ids differ from the rebuilt corpus")
            swaps_b = 0
        else:
            swaps_b = compare_rankings(ids, sc, ids_b, sc_b,
                                       f"filter {spec} vs rebuilt corpus")
        del rb
        # (c) the plain filtered path
        ids_p, sc_p, dt_p, _ = run_cascade(r, bench, plain, args.batch, spec)
        swaps = compare_rankings(ids, sc, ids_p, sc_p,
                                 f"filter {spec} kernel vs plain")
        m = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
        results[str(spec)] = dict(qps=nq / dt, plain_qps=nq / dt_p,
                                  n_match=len(match), metrics=m)
        log(f"[filter] {spec}: {len(match)} matching pages; kernel QPS="
            f"{nq / dt:.1f}, plain QPS={nq / dt_p:.1f}; no id outside the "
            f"filter; == rebuilt corpus "
            + ("bit for bit (ids and scores)" if bitwise else
               f"to float tolerance, NOT bit for bit ({swaps_b} tie swaps)")
            + f"; kernel == plain ids ({swaps} tie swaps); " + "  ".join(
                f"{k}={v:.4f}" for k, v in m.items()))
    counts = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    log(f"[filter] kernel launches over the filtered path: {counts}")
    for k in ("maxsim_scan", "maxsim_rerank"):
        check(counts[k] > 0, f"kernel {k} was never launched on the "
              "filtered path")
    return dict(results=results, counts=counts, retriever=r, specs=specs)


# ---------------------------------------------------------------------------
# phase 4d: IVF-routed search
# ---------------------------------------------------------------------------

def routed_path(args, dev, main) -> dict:
    """The phase-4 pages clustered into 64 IVF clusters; the routed 2-stage
    kernel cascade at full probe against the exhaustive one, and at
    n_probe 8. Returns the routed store too (phase 4p holds its mesh twin
    against it)."""
    from repro_torch.core import multistage as MST
    from repro_torch.data.synthetic import evaluate_ranking
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.retrieval.retriever import Retriever
    from repro_torch.retrieval.routing import RoutingPolicy
    from repro_torch.retrieval.segments import bucket_capacity

    bench = main["bench"]
    ex = main["results"][2]                       # exhaustive 2-stage
    n_clusters = 64
    t0 = time.perf_counter()
    r = Retriever(base_store(main), capacity=bucket_capacity(args.pages),
                  device=dev, routing=RoutingPolicy(n_clusters))
    torch.cuda.synchronize()
    seg = r.store.segments[0]
    fills = seg.routing.fills
    log(f"[routed] clustered {r.n_docs} pages into {n_clusters} clusters "
        f"in {time.perf_counter() - t0:.2f}s (member lists "
        f"{tuple(seg.vectors['ivf_members'].shape)}; cluster sizes "
        f"{int(fills.min())}..{int(fills.max())}, median "
        f"{int(np.median(fills))})")
    two = MST.with_rerank_policy(MST.with_scan_policy(
        MST.two_stage(256, 10), use_kernel=True), rerank_kernel=True)
    # the exhaustive kernel ranking one deeper, for compare_rankings
    ex_ids, ex_sc, _, _ = run_cascade(main["retriever"], bench,
                                      plus_one(two), args.batch)
    results = {}
    DSP.reset_counts()
    for n_probe in (n_clusters, 8):
        st = MST.with_routing_policy(two, n_probe=n_probe,
                                     n_clusters=n_clusters)
        ids, sc, dt, nq = run_cascade(r, bench, st, args.batch)
        m = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
        recall = float(np.mean([len(set(a) & set(b)) / len(b)
                                for a, b in zip(ids, ex["ids"])]))
        results[n_probe] = dict(qps=nq / dt, metrics=m, recall_vs_ex=recall,
                                ms_batch=1e3 * dt / -(-nq // args.batch))
        line = (f"[routed] 2-stage n_probe={n_probe}/{n_clusters}: QPS="
                f"{nq / dt:.1f} (exhaustive {ex['qps']:.1f}); recall@10 vs "
                f"the exhaustive ids {recall:.4f}; " + "  ".join(
                    f"{k}={v:.4f}" for k, v in m.items()))
        if n_probe == n_clusters:
            swaps = compare_rankings(ids, sc, ex_ids, ex_sc,
                                     "full-probe routed vs exhaustive 2-stage",
                                     tie=0.0)
            for k in m:
                check(abs(m[k] - ex["metrics"][k]) < 5e-4,
                      f"full probe {k}: routed {m[k]:.4f} != exhaustive "
                      f"{ex['metrics'][k]:.4f} to 3 decimals")
            line += (f"; == exhaustive ids ({swaps} exact-tie swaps), "
                     "metrics equal to 3 decimals")
        log(line)
    counts = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    log(f"[routed] kernel launches over the routed path: {counts}")
    for k in ("ivf_route", "maxsim_rerank"):
        check(counts[k] > 0, f"kernel {k} was never launched on the routed "
              "path")
    routed_stage0_times(args, dev, r, bench, two, n_clusters)
    return dict(results=results, counts=counts, retriever=r,
                n_clusters=n_clusters)


def routed_stage0_times(args, dev, r, bench, two, n_clusters: int) -> None:
    """Where a routed stage 0 spends its time on one query batch: the
    centroid scores, the probed rows through the rerank kernel, and the
    exhaustive scan over the same vectors it replaces (CUDA events)."""
    from repro_torch.kernels.maxsim import ops as KOPS
    from repro_torch.retrieval import engine
    from repro_torch.retrieval.store import VALIDITY_KEY

    vec = r.store.vectors
    mp, mpm = vec["mean_pooling"], vec["mean_pooling_mask"]
    q = torch.as_tensor(bench.queries[:args.batch]).to(dev)
    qm = torch.as_tensor(bench.query_mask[:args.batch]).to(dev)
    cents = vec["ivf_centroids"]
    cs = time_ms(lambda: KOPS.centroid_scores(q, cents, qm))
    scan = time_ms(lambda: KOPS.maxsim_scores(q, mp, qm, mpm))
    parts = [f"centroid_scores [{q.shape[0]},{cents.shape[0]}] {cs:.3f} ms",
             f"exhaustive scan [{mp.shape[0]},{mp.shape[1]}] {scan:.3f} ms"]
    for n_probe in (8, n_clusters):
        st = dataclasses.replace(two[0], n_probe=n_probe)
        rows = engine._routed_rows(vec, st, q, qm).long()
        live = int((rows >= 0).sum())
        ok = (rows >= 0) & vec[VALIDITY_KEY][rows.clamp(0)]
        rows = rows.clamp(0)
        ms = time_ms(lambda: KOPS.maxsim_rerank(q, mp, rows, qm, mpm, ok))
        parts.append(f"n_probe {n_probe}: rerank kernel over rows "
                     f"{list(rows.shape)} ({100 * live / rows.numel():.1f}% "
                     f"live) {ms:.3f} ms")
    log("[routed] stage-0 times, one batch: " + "; ".join(parts))


HBM_TBS = 3.35          # the H100 SXM's memory rate, TB/s


def cost_model_path(args, main, int8, routed) -> dict:
    """Phase 4's per-stage account: for the float 1-, 2- and 3-stage
    kernel cascades, 4b's int8 cascades and 4d's routed 2-stage (n_probe
    64 and 8), ``multistage.qps_cost_model``'s multiply-adds a query (and
    the ratio to the 1-stage cascade's) and ``cascade_hbm_bytes``' bytes a
    batch per stage and in all, those bytes at ``HBM_TBS``, beside this
    run's measured ms a batch. Printed, with no limit: the models bill
    what a stage must read and compute, not what the kernels take."""
    from repro_torch.core import multistage as MST

    store = main["retriever"].store
    n = main["retriever"].n_docs
    dims, vdims = store.dims(), store.vec_dims()
    qv = int(main["bench"].query_mask.sum(1).max())     # valid tokens
    d = main["bench"].queries.shape[-1]
    B = args.batch

    def kern(stages, **scan):
        return MST.with_rerank_policy(MST.with_scan_policy(
            stages, use_kernel=True, **scan), rerank_kernel=True)

    one, two = MST.one_stage(10), MST.two_stage(256, 10)
    rows = {f"{k}-stage float": (kern(st), {}, main["results"][k])
            for k, st in ((1, one), (2, two),
                          (3, MST.three_stage(1024, 256, 10)))}
    for name, (r, stages, topk) in int8["cascades"].items():
        codes = "initial" if r is int8["ra"] else "mean_pooling"
        rows[name] = (kern(stages, chunk=256, scan_topk=topk), {codes: 1},
                      int8["results"][name])
    for n_probe, res in routed["results"].items():
        rows[f"routed 2-stage n_probe={n_probe}"] = (
            MST.with_routing_policy(kern(two), n_probe=n_probe,
                                    n_clusters=routed["n_clusters"]),
            {}, res)
    base = MST.qps_cost_model(n, qv, d, rows["1-stage float"][0], dims,
                              vdims)
    out = {}
    for name, (st, bpc, res) in rows.items():
        madds = MST.qps_cost_model(n, qv, d, st, dims, vdims)
        bill = MST.cascade_hbm_bytes(n, qv, d, st, dims, vdims, batch=B,
                                     bytes_per_coord=bpc)
        model_ms = bill["total_bytes"] / (HBM_TBS * 1e12) * 1e3
        out[name] = dict(madds=madds, ratio=base / madds, bytes=bill,
                         model_ms=model_ms, ms=res["ms_batch"])
        log(f"[cost] {name}: {madds:.4e} madds a query ({base / madds:.2f}x"
            f" fewer than the 1-stage cascade); bytes a batch of {B}: "
            + "; ".join(f"{e['kind']} {e['stage']} {e['read_bytes']:.4e} "
                        f"read + {e['score_write_bytes']:.4e} written"
                        for e in bill["stages"])
            + f"; total {bill['total_bytes']:.4e} B = {model_ms:.4f} ms at "
            f"{HBM_TBS} TB/s; measured {res['ms_batch']:.4f} ms a batch "
            f"({res['ms_batch'] / model_ms:.2f}x the byte model)")
    log(f"[cost] inputs: N={n}, {qv} valid query tokens (of "
        f"{main['bench'].queries.shape[1]} slots), d={d}, vectors per page "
        f"{dims}, widths {vdims}; madds from multistage.qps_cost_model, "
        "bytes from multistage.cascade_hbm_bytes (the query reads not "
        "billed), ms a batch over this run's timed batches")
    return out


# ---------------------------------------------------------------------------
# phase 4e: the scan's compute-type policy (Stage.dtype)
# ---------------------------------------------------------------------------

def dtype_path(args, dev, main) -> dict:
    """The 2-stage cascade with ``Stage.dtype="bfloat16"`` on the scan
    stage (query and float documents cast to bf16; the kernel reads the
    cast query widened to f32) through the kernels, against the same
    cascade through the plain path on the card. (A 1-stage cascade's
    plain bf16 scan returns bf16 scores, as ``repro``'s does, whose
    rounding reorders its top-10 against any f32 ranking; the kernel
    returns f32 scores of the same bf16 inputs.)"""
    from repro_torch.core import multistage as MST
    from repro_torch.data.synthetic import evaluate_ranking
    from repro_torch.kernels import dispatch as DSP

    r, bench = main["retriever"], main["bench"]
    results = {}
    for n, stages in ((2, MST.two_stage(256, 10)),):
        kern = MST.with_rerank_policy(MST.with_scan_policy(
            stages, use_kernel=True, dtype="bfloat16"), rerank_kernel=True)
        DSP.reset_counts()
        ids, sc, dt, nq = run_cascade(r, bench, kern, args.batch)
        counts = {k: DSP.launch_count(k) for k in DSP.KERNELS}
        check(counts["maxsim_scan"] > 0, f"dtype {n}-stage: the scan kernel "
              "was never launched")
        plain = MST.with_scan_policy(plus_one(stages), use_kernel=False,
                                     chunk=256, dtype="bfloat16")
        ids_p, sc_p, dt_p, _ = run_cascade(r, bench, plain, args.batch)
        swaps = compare_rankings(ids, sc, ids_p, sc_p,
                                 f"dtype bf16 {n}-stage kernel vs plain")
        m, mp = (evaluate_ranking(x, bench.qrels, ks=(5, 10))
                 for x in (ids, ids_p))
        for k in m:
            check(abs(m[k] - mp[k]) < 5e-4, f"dtype bf16 {n}-stage {k}: "
                  f"kernel {m[k]:.4f} != plain {mp[k]:.4f} to 3 decimals")
        f32 = main["results"][n]["metrics"]["ndcg@10"]
        results[n] = dict(qps=nq / dt, plain_qps=nq / dt_p, metrics=m,
                          counts=counts)
        log(f"[dtype] {n}-stage Stage.dtype=bfloat16: kernel QPS "
            f"{nq / dt:.1f}, plain QPS {nq / dt_p:.1f}; kernel == plain ids "
            f"({swaps} tie swaps), metrics equal to 3 decimals; " + "  ".join(
                f"{k}={v:.4f}" for k, v in m.items())
            + f" (f32 scan ndcg@10 {f32:.4f}); launches {used(counts)}")
    return results


def used(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


# ---------------------------------------------------------------------------
# phase 4f: routed full probe on duplicate pages (exact ties)
# ---------------------------------------------------------------------------

def duplicate_routed_path(args, dev, main) -> dict:
    """The phase-4 pages plus a second copy of the first 256 (each copy
    ties its original exactly at every stage), clustered into 64 IVF
    clusters: the routed 2-stage kernel cascade at full probe must give
    the exhaustive kernel cascade's ids exactly, ties included."""
    from repro_torch.core import multistage as MST
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.retrieval.retriever import Retriever
    from repro_torch.retrieval.routing import RoutingPolicy
    from repro_torch.retrieval.segments import bucket_capacity
    from repro_torch.retrieval.store import VectorStore

    bench = main["bench"]
    base = base_store(main)
    n, n_dup = base.n_docs, 256
    store = VectorStore({k: torch.cat([v, v[:n_dup]]) for k, v in
                         base.vectors.items()}, n + n_dup)
    r = Retriever(store, capacity=bucket_capacity(n + n_dup), device=dev,
                  routing=RoutingPolicy(64))
    two = MST.with_rerank_policy(MST.with_scan_policy(
        MST.two_stage(256, 10), use_kernel=True), rerank_kernel=True)
    DSP.reset_counts()
    ids_x, sc_x, _, nq = run_cascade(r, bench, two, args.batch)
    ids_r, sc_r, dt, _ = run_cascade(r, bench, MST.with_routing_policy(
        two, n_probe=64, n_clusters=64), args.batch)
    counts = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    for k in ("maxsim_scan", "maxsim_rerank", "ivf_route"):
        check(counts[k] > 0, f"duplicate pages: kernel {k} was never "
              "launched")
    check(np.array_equal(ids_r, ids_x), "duplicate pages: routed full probe "
          f"ids differ from the exhaustive ids at "
          f"{int((ids_r != ids_x).sum())} places")
    check(np.allclose(sc_r, sc_x, rtol=1e-5, atol=1e-4),
          "duplicate pages: routed scores differ from the exhaustive ones")
    pairs = int(sum(len(set(row) & set(row + n)) for row in ids_x))
    check(pairs > 0, "duplicate pages: no result holds a page and its copy")
    log(f"[dup] {n} pages + {n_dup} copies, 64 clusters: routed full probe "
        f"== exhaustive ids exactly over {nq} queries ({pairs} page/copy "
        f"pairs tied in the top-10s, each in slot order); routed QPS "
        f"{nq / dt:.1f}; launches {used(counts)}")
    del r
    return dict(pairs=pairs, counts=counts)


# ---------------------------------------------------------------------------
# phase 4g: the fused ingest
# ---------------------------------------------------------------------------

def same_segments(a, b, what: str) -> int:
    """Every segment array of stores ``a`` and ``b`` equal bit for bit
    (never-claimed slots included), and the same fills and page ids.
    Returns the number of arrays compared."""
    check(a.capacities == b.capacities, f"{what}: capacities "
          f"{a.capacities} != {b.capacities}")
    n = 0
    for sa, sb in zip(a.segments, b.segments):
        check(sa.n_docs == sb.n_docs and np.array_equal(sa.doc_ids,
                                                        sb.doc_ids),
              f"{what}: fills or page ids differ")
        check(set(sa.vectors) == set(sb.vectors), f"{what}: key sets differ")
        for k in sa.vectors:
            check(sa.vectors[k].dtype == sb.vectors[k].dtype
                  and bool(torch.equal(sa.vectors[k], sb.vectors[k])),
                  f"{what}: {k} differs")
            n += 1
    return n


def ingest_path(args, dev, main) -> dict:
    """The phase-4 pages through ``Retriever.ingest`` in batches of 64 (the
    fused write, pooling kernel) into a store seeded with the first batch,
    against ``IngestPipeline.index`` + ``add_pages`` of the same batches
    on the same pipeline; then the 2-stage kernel cascade over the
    ingested store, and the serve CLI's fused-ingest mode."""
    from repro_torch.configs import get_config
    from repro_torch.core import multistage as MST
    from repro_torch.data.synthetic import evaluate_ranking
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.launch import serve
    from repro_torch.retrieval import tracing
    from repro_torch.retrieval.ingest import IngestPipeline, batch_bucket
    from repro_torch.retrieval.retriever import Retriever
    from repro_torch.retrieval.segments import bucket_capacity

    bench = main["bench"]
    tt = bench.token_types
    n, step = len(bench.pages), 64
    pipe = IngestPipeline.for_config(get_config("colpali"), device=dev)
    check(pipe.pool_path == "fused-cuda", f"pool path {pipe.pool_path}")
    cap = bucket_capacity(n)
    DSP.reset_counts()
    fused = Retriever(pipe.index(bench.pages[:step], tt), capacity=cap,
                      device=dev, ingest=pipe)
    seen, deltas = set(), []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(step, n, step):
        bucket = batch_bucket(len(bench.pages[i:i + step]))
        before = tracing.trace_count()
        fused.ingest(bench.pages[i:i + step], tt)
        if bucket in seen:
            deltas.append(tracing.trace_count() - before)
        seen.add(bucket)
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    counts = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    check(counts["pooling"] > 0, "the fused ingest never launched the "
          "pooling kernel")
    check(deltas and not any(deltas), "fused ingest: a batch after the "
          f"first of its bucket built something (deltas {sorted(set(deltas))})")
    legacy = Retriever(pipe.index(bench.pages[:step], tt), capacity=cap,
                       device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(step, n, step):
        legacy.upsert(pipe.index(bench.pages[i:i + step], tt))
    torch.cuda.synchronize()
    t_legacy = time.perf_counter() - t0
    n_arrays = same_segments(fused.store, legacy.store,
                             "fused ingest vs index + add_pages")
    del legacy
    pad = padding_cost(pipe, bench, dev)
    pps, pps_legacy = (n - step) / t_fused, (n - step) / t_legacy
    log(f"[ingest] {n - step} pages in batches of {step} (bucket "
        f"{sorted(seen)}) into capacity {cap}: fused Retriever.ingest "
        f"{pps:.1f} pages/s, index + add_pages {pps_legacy:.1f} pages/s "
        f"(host pages -> card included); {n_arrays} segment arrays equal "
        f"bit for bit; build delta 0 over {len(deltas)} batches after the "
        f"first; launches {used(counts)}")
    two = MST.with_rerank_policy(MST.with_scan_policy(
        MST.two_stage(256, 10), use_kernel=True), rerank_kernel=True)
    ids, sc, dt, nq = run_cascade(fused, bench, two, args.batch)
    m = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
    want = main["results"][2]["metrics"]
    check(abs(m["ndcg@10"] - want["ndcg@10"]) < 5e-5,
          f"ingested store: 2-stage ndcg@10 {m['ndcg@10']:.4f} != phase 4's "
          f"{want['ndcg@10']:.4f}")
    log(f"[ingest] 2-stage kernels over the ingested store: QPS "
        f"{nq / dt:.1f}, ndcg@10={m['ndcg@10']:.4f} (phase 4 "
        f"{want['ndcg@10']:.4f})")
    del fused
    # the serve CLI's fused-ingest mode
    DSP.reset_counts()
    out = serve.main(["--pages", "512", "--queries", "60", "--stages", "2",
                      "--use-kernel", "--rerank-kernel", "--ingest-batches",
                      "8", "--ingest-batch-size", "64", "--ingest-pipeline"])
    c = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    check(out["builds"] == 0, "serve --ingest-pipeline: steady-state builds "
          f"{out['builds']}")
    for k in ("pooling", "maxsim_scan", "maxsim_rerank"):
        check(c[k] > 0, f"serve --ingest-pipeline never launched {k}")
    log(f"[ingest] serve.py --ingest-pipeline: {out['pages_per_s']:.1f} "
        f"pages/s, search-after-ingest QPS {out['qps']:.1f}, builds 0; "
        f"launches {used(c)}")
    return dict(pps=pps, pps_legacy=pps_legacy, counts=counts,
                serve=out, pad=pad)


def padding_cost(pipe, bench, dev) -> dict:
    """What bucket padding costs ``index``: 129 pages (padded to the
    256-row bucket) against the same pages indexed unpadded (the body on
    129 rows) and against 128 pages (a bucket size, no padding). Pages
    are on the card first, so the times are the card's work."""
    tt = bench.token_types
    pages = {n: torch.as_tensor(bench.pages[:n]).to(dev) for n in (128, 129)}

    def unpadded(x):
        return pipe._index_arrays(*pipe._admit(x, tt), None)

    t = {"129 padded to 256": time_ms(lambda: pipe.index(pages[129], tt)),
         "129 unpadded": time_ms(lambda: unpadded(pages[129])),
         "128 (a bucket)": time_ms(lambda: pipe.index(pages[128], tt))}
    log("[ingest] bucket padding's cost to IngestPipeline.index, ms (median "
        "of 10, pages on the card): " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()) +
        f"; padded / unpadded {t['129 padded to 256'] / t['129 unpadded']:.3f}")
    return t


# ---------------------------------------------------------------------------
# phase 4h: the serving frontend
# ---------------------------------------------------------------------------

def frontend_path(args, dev, main) -> dict:
    """The 2-stage kernel cascade behind a ``ServingFrontend`` over the
    phase-4 store: (s) the benchmark queries all due at once, whose served
    rate is the frontend's capacity, (a) the same queries replayed open
    loop at half that capacity, (b) the same queries cut to 4-16 token slots,
    each held bit for bit against a per-request ``Retriever.search``; then
    the serve CLI's traffic mode over an int8 store with the chunked
    (double-buffered) scan."""
    from repro_torch.core import multistage as MST
    from repro_torch.data.synthetic import evaluate_ranking
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.launch import serve
    from repro_torch.retrieval import tracing
    from repro_torch.retrieval.frontend import replay_open_loop

    r, bench = main["retriever"], main["bench"]
    two = MST.with_rerank_policy(MST.with_scan_policy(
        MST.two_stage(256, 10), use_kernel=True), rerank_kernel=True)
    fe = r.frontend(two, max_batch=16, max_q=32, flush_ms=2.0)
    t0 = time.perf_counter()
    n_warm = fe.warm()
    log(f"[frontend] warmed {n_warm} buckets (B {fe.b_buckets} x Q "
        f"{fe.q_buckets}) in {time.perf_counter() - t0:.2f}s")
    nq = len(bench.queries)
    want = main["results"][2]["metrics"]["ndcg@10"]
    DSP.reset_counts()
    builds0 = tracing.trace_count()
    res = {}
    reqs = [(bench.queries[j], bench.query_mask[j]) for j in range(nq)]

    def replay(reqs, rate: float, seed: int, what: str) -> tuple:
        st0 = dict(fe.stats)
        served, wall = replay_open_loop(fe, reqs, rate, seed=seed)
        check(len(served) == nq and all(p.error is None for p in served),
              f"frontend ({what}): a request failed or was dropped")
        return served, frontend_stats(
            served, wall, {k: fe.stats[k] - st0[k] for k in fe.stats}, rate)

    def ndcg(served, what: str) -> dict:
        ids = np.concatenate([p.ids for p in served])
        m = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
        check(abs(m["ndcg@10"] - want) < 5e-5, f"frontend ({what}) ndcg@10 "
              f"{m['ndcg@10']:.4f} != phase 4's 2-stage {want:.4f}")
        return dict(ndcg=m["ndcg@10"], ids_equal=int(
            (ids == main["results"][2]["ids"]).all(axis=1).sum()))

    # (s) saturation: every request due at once; the frontend's capacity
    served, res["s"] = replay(reqs, 1e9, args.seed, "saturated")
    res["s"]["rate"] = None
    res["s"].update(ndcg(served, "saturated"))
    rate = 0.5 * res["s"]["qps"]
    # (a) whole benchmark queries, open loop at half that capacity
    served, res["a"] = replay(reqs, rate, args.seed, "open loop")
    res["a"].update(ndcg(served, "open loop"))
    # (b) the same queries cut to 4..16 token slots
    rng = np.random.default_rng(args.seed)
    cut = rng.integers(4, 17, size=nq)
    reqs = [(bench.queries[j, :cut[j]], bench.query_mask[j, :cut[j]])
            for j in range(nq)]
    served, res["b"] = replay(reqs, rate, args.seed + 1, "cut queries")
    builds = tracing.trace_count() - builds0
    check(res["b"]["padded_share"] > 0,
          "frontend (cut queries): no dispatched block held a padded row")
    counts = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    for k in ("maxsim_scan", "maxsim_rerank"):
        check(counts[k] > 0, f"frontend: kernel {k} was never launched")
    check(builds == 0, f"frontend traffic built {builds} libraries or "
          "search functions after warm()")
    for (q, qm), pr in zip(reqs, served):
        s, i = r.search(q[None], qm[None], stages=two)
        check(np.array_equal(pr.ids, i) and np.array_equal(
            pr.scores, s.float().cpu().numpy()),
            "frontend: a micro-batched result differs from the per-request "
            "Retriever.search of the same cut query")
    for part, what in (("s", "benchmark queries, all due at once"),
                       ("a", "benchmark queries, open loop at 0.5x (s)"),
                       ("b", "cut to 4-16 token slots, open loop at 0.5x "
                             "(s)")):
        x = res[part]
        log(f"[frontend] ({part}) {nq} {what}: offered {offered(x)}, "
            f"served {x['qps']:.1f} req/s, p50 {x['p50']:.3f} ms, "
            f"p99 {x['p99']:.3f} ms, {x['dispatches']} dispatches, "
            f"padded-row share {x['padded_share']:.4f}")
    log(f"[frontend] (s, a) ndcg@10={res['a']['ndcg']:.4f} == phase 4's "
        f"2-stage ({res['s']['ids_equal']}, {res['a']['ids_equal']}/{nq} id "
        f"rows equal); (b) every "
        f"result == per-request Retriever.search bit for bit; builds over "
        f"traffic {builds}; launches {used(counts)}")
    # the serve CLI's traffic mode: int8 store, chunked scan
    DSP.reset_counts()
    out = serve.main(["--pages", "512", "--queries", "60", "--stages", "2",
                      "--use-kernel", "--rerank-kernel", "--int8", "--chunk",
                      "256", "--traffic", "300"])
    c = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    check(out["builds"] == 0, f"serve --traffic: builds {out['builds']}")
    for k in ("maxsim_scan_db", "maxsim_rerank"):
        check(c[k] > 0, f"serve --traffic --int8 --chunk never launched {k}")
    log(f"[frontend] serve.py --traffic --int8 --chunk 256: p50 "
        f"{out['p50']:.3f} ms, p99 {out['p99']:.3f} ms, QPS "
        f"{out['qps']:.1f}; launches {used(c)}")
    return dict(res=res, counts=counts, serve=out)


def offered(x: dict) -> str:
    return "all at once" if x["rate"] is None else f"{x['rate']:.1f} req/s"


def frontend_stats(served, wall: float, st: dict, rate: float) -> dict:
    lat = np.asarray([p.latency for p in served]) * 1e3
    rows = st["rows_real"] + st["rows_padded"]
    return dict(p50=float(np.percentile(lat, 50)),
                p99=float(np.percentile(lat, 99)), qps=len(served) / wall,
                dispatches=st["dispatches"], rate=rate,
                padded_share=st["rows_padded"] / max(rows, 1))


# ---------------------------------------------------------------------------
# phase 4i: Matryoshka stage and the quickstart
# ---------------------------------------------------------------------------

def matryoshka_quickstart_path(args, dev, main) -> dict:
    """``add_truncated_stage(..., "mean_pooling", 32)`` over the phase-4
    pages and the cascade (mean_pooling_mrl32, 128), (initial, 10) through
    the kernels against the plain path; then
    ``examples/quickstart_torch.py`` on the card and on the CPU."""
    import contextlib
    import importlib.util
    import io
    from repro_torch.core import multistage as MST
    from repro_torch.core.matryoshka import add_truncated_stage
    from repro_torch.data.synthetic import evaluate_ranking
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.kernels.maxsim import ops as KOPS
    from repro_torch.retrieval.retriever import Retriever
    from repro_torch.retrieval.store import VectorStore

    bench = main["bench"]
    base = base_store(main)
    r = Retriever(VectorStore(add_truncated_stage(base.vectors,
                                                  "mean_pooling", 32),
                              base.n_docs), device=dev)
    vec = r.store.vectors["mean_pooling_mrl32"]
    route = KOPS.scan_route(vec.dtype, vec.shape[1], vec.shape[2])
    check(route == "tensor", f"the d=32 scan takes the {route} route")
    mrl = (MST.Stage("mean_pooling_mrl32", 128), MST.Stage("initial", 10))
    kern = MST.with_rerank_policy(MST.with_scan_policy(mrl, use_kernel=True),
                                  rerank_kernel=True)
    DSP.reset_counts()
    ids, sc, dt, nq = run_cascade(r, bench, kern, args.batch)
    counts = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    for k in ("maxsim_scan", "maxsim_rerank"):
        check(counts[k] > 0, f"MRL32 cascade: kernel {k} was never launched")
    plain = MST.with_scan_policy(plus_one(mrl), use_kernel=False, chunk=256)
    ids_p, sc_p, dt_p, _ = run_cascade(r, bench, plain, args.batch)
    swaps = compare_rankings(ids, sc, ids_p, sc_p, "MRL32 kernel vs plain")
    m = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
    mp = evaluate_ranking(ids_p, bench.qrels, ks=(5, 10))
    for k in m:
        check(abs(m[k] - mp[k]) < 5e-4, f"MRL32 {k}: kernel {m[k]:.4f} != "
              f"plain {mp[k]:.4f} to 3 decimals")
    log(f"[mrl] {tuple(vec.shape)} {vec.dtype} (scan route {route}): "
        f"(mean_pooling_mrl32, 128), (initial, 10) kernels QPS "
        f"{nq / dt:.1f}, plain QPS {nq / dt_p:.1f}; kernel == plain ids "
        f"({swaps} tie swaps); " + "  ".join(f"{k}={v:.4f}"
                                             for k, v in m.items())
        + f" (2-stage mean_pooling ndcg@10 "
        f"{main['results'][2]['metrics']['ndcg@10']:.4f}); launches "
        f"{used(counts)}")
    del r
    # the quickstart, on the card and on the CPU
    path = Path(__file__).resolve().parent / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    lines, secs = {}, {}
    DSP.reset_counts()
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            qs.main(["--device", device])
        secs[device] = time.perf_counter() - t0
        lines[device] = buf.getvalue().splitlines()
        if device == "cuda":
            qcounts = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    for k in ("maxsim_scan", "maxsim_rerank"):
        check(qcounts[k] > 0, f"quickstart on the card never launched {k}")
    search = {d: [ln for ln in v if ln.startswith("[search]")]
              for d, v in lines.items()}
    check(len(search["cuda"]) == 3 and search["cuda"] == search["cpu"],
          f"quickstart metric lines differ: {search}")
    check(any("steady-state retraces: 0" in ln for ln in lines["cuda"]),
          "quickstart on the card: steady-state builds")
    for ln in lines["cuda"]:
        log(f"[quickstart] {ln}")
    log(f"[quickstart] card run {secs['cuda']:.1f}s, CPU run "
        f"{secs['cpu']:.1f}s: the [search] lines are equal; card launches "
        f"{used(qcounts)}")
    return dict(metrics=m, qps=nq / dt, plain_qps=nq / dt_p, counts=counts,
                quickstart=search["cuda"], quickstart_counts=qcounts)


# ---------------------------------------------------------------------------
# phase 4j: tiered residency, faults and snapshots
# ---------------------------------------------------------------------------

def copy_rates(nbytes: int, dev) -> dict:
    """Host-to-card GB/s of one segment's bytes from pinned and from
    pageable host memory (median of 5 CUDA-event samples each)."""
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = {}
    for kind, pin in (("pinned", True), ("pageable", False)):
        src = torch.ones(nbytes, dtype=torch.uint8, pin_memory=pin)
        ms = time_ms(lambda: dst.copy_(src, non_blocking=True), iters=5)
        out[kind] = nbytes / ms / 1e6
    del dst
    return out


def flip_leaf_bit(step_dir: str, index: int) -> None:
    """Flip one bit in the middle of member ``leaf_<index>.npy`` of the
    step's ``arrays.npz``, in place on disk."""
    import struct
    import zipfile
    path = Path(step_dir) / "arrays.npz"
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(f"leaf_{index}.npy")
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 26)
        n_name, n_extra = struct.unpack("<HH", f.read(4))
        pos = info.header_offset + 30 + n_name + n_extra \
            + info.file_size // 2
        f.seek(pos)
        b = f.read(1)[0]
        f.seek(pos)
        f.write(bytes([b ^ 1]))


def same_result(got, want, what: str) -> None:
    """A tiered result equal to ``want`` (scores tensor, ids) bit for
    bit."""
    gs, gi = got
    ws, wi = want
    check(bool(torch.equal(gs, ws)) and np.array_equal(gi, wi),
          f"{what}: tiered result != the resident search bit for bit")


def tiered_path(args, dev, main) -> dict:
    """The phase-4 pages as 8 segments of ``pages/8`` behind a
    ``TieredEngine`` whose budget holds 3 of them: (a) whole corpus with
    prefetch overlap on, then off, (b) a hot scope of 2 segments, (c)
    scopes alternating hot and cold, (d) a deadline below one promotion
    with ``DegradePolicy()``, (e) injected transfer failures and worker
    deaths, (f) snapshot and restore, a bit flipped on disk; (g) an int8
    8-segment store through its own engine. Every undegraded result must
    equal the resident search bit for bit."""
    import shutil
    import tempfile
    from repro_torch.core import multistage as MST
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.retrieval import tracing
    from repro_torch.retrieval.faults import FaultPlan
    from repro_torch.retrieval.retriever import Retriever
    from repro_torch.retrieval.store import (VectorStore, as_filter_arrays,
                                             quantize_store)
    from repro_torch.retrieval.tiering import DegradePolicy
    from repro_torch.training.checkpoint import CheckpointCorrupt

    bench = main["bench"]
    base = base_store(main)
    n, n_segs = base.n_docs, 8
    per = n // n_segs
    check(per * n_segs == n and per >= 64, f"{n} pages do not split into "
          f"{n_segs} segments of at least 64 (the minimum capacity)")

    def eight_segments(vectors: dict):
        r = Retriever(VectorStore({k: v[:per] for k, v in vectors.items()},
                                  per), device=dev)
        for lo in range(per, n, per):
            r.upsert(VectorStore({k: v[lo:lo + per]
                                  for k, v in vectors.items()}, per))
        check(r.store.capacities == (per,) * n_segs,
              f"tiered store: capacities {r.store.capacities}")
        return r

    two = MST.with_rerank_policy(MST.with_scan_policy(
        MST.two_stage(256, 10), use_kernel=True), rerank_kernel=True)
    q, qm, B = bench.queries, bench.query_mask, args.batch
    batches = [(q[i:i + B], qm[i:i + B]) for i in range(0, len(q), B)]
    counts = {k: 0 for k in DSP.KERNELS}

    def counted(fn):
        """Run ``fn`` with the launch counters zeroed before and added to
        this phase's counts after (oracle runs stay uncounted)."""
        DSP.reset_counts()
        out = fn()
        for k in DSP.KERNELS:
            counts[k] += DSP.launch_count(k)
        return out

    def timed(fn) -> tuple:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    r8 = eight_segments(base.vectors)
    seg_bytes = r8.store.segments[0].nbytes
    total = sum(s.nbytes for s in r8.store.segments)
    rates = copy_rates(seg_bytes, dev)
    log(f"[tiered] {n_segs} segments of {per} pages, {seg_bytes / 1e6:.1f} "
        f"MB each, {total / 1e9:.3f} GB in all; host->card copy of one "
        f"segment: pinned {rates['pinned']:.2f} GB/s, pageable "
        f"{rates['pageable']:.2f} GB/s (median of 5)")

    # ---- oracles: the resident 2-stage search per batch, its working
    # set, and the scoped searches of (b)-(c) through an engine whose
    # budget holds the whole corpus (the same per-segment code, no copy)
    r8.search(*batches[0], stages=two)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    oracle, dt_res = timed(lambda: [r8.search(bq, bm, stages=two)
                                    for bq, bm in batches])
    ws = torch.cuda.max_memory_allocated() - m0
    hot = (0, 1)
    scopes = (hot, (4, 5), hot, (2, 3, 6), hot, (7,))
    with r8.tiered(2 * total, prefetch=False) as full:
        check(len(full.resident()) == n_segs, "unbudgeted engine spilled")
        scoped = {sc: [full.search(bq, bm, stages=two, scope=sc)
                       for bq, bm in batches] for sc in set(scopes)}
        check(full.stats["promotions"] == 0, "unbudgeted engine promoted")
    r_hot = Retriever(VectorStore({k: v[:len(hot) * per] for k, v in
                                   base.vectors.items()}, len(hot) * per),
                      device=dev)
    r_hot.search(*batches[0], stages=two)
    _, dt_hot_res = timed(lambda: [r_hot.search(bq, bm, stages=two)
                                   for bq, bm in batches])
    del r_hot
    budget = 3 * seg_bytes
    res = {"segments": n_segs, "batches": len(batches),
           "seg_mb": seg_bytes / 1e6,
           "total_gb": total / 1e9, "h2d": rates,
           "resident_qps": len(q) / dt_res}
    eng = r8.tiered(budget)
    try:
        check(len(eng.resident()) == 3 and eng.resident_bytes <= budget,
              f"budget of 3 segments: resident {eng.resident()}")
        log(f"[tiered] budget {budget / 1e6:.1f} MB (3 of {n_segs} "
            f"segments), {n_segs - 3} on the pinned host tier; resident "
            f"2-stage search over the 8 segments {len(q) / dt_res:.1f} QPS "
            f"(batches of {B}), working set {ws / 1e6:.1f} MB")

        # (a) whole corpus, prefetch overlap on, then off
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated() - eng.resident_bytes
        torch.cuda.reset_peak_memory_stats()
        for overlap in (True, False):
            st0 = dict(eng.stats)
            got, dt = timed(lambda: counted(lambda: [
                eng.search(bq, bm, stages=two, overlap=overlap)
                for bq, bm in batches]))
            for b, (g, o) in enumerate(zip(got, oracle)):
                check(not g.degraded, "(a) undeadlined result degraded")
                same_result(g, o, f"(a) overlap={overlap} batch {b}")
            d = {k: eng.stats[k] - st0[k] for k in
                 ("promotions", "demotions", "bytes_h2d", "bytes_d2h",
                  "wait_s")}
            mode = "overlap" if overlap else "sync"
            res[mode] = dict(qps=len(q) / dt, **d,
                             h2d_gbs=d["bytes_h2d"] / dt / 1e9,
                             promote_gbs=seg_bytes / eng._promote_ema / 1e9)
            log(f"[tiered] (a) whole corpus, prefetch {mode}: "
                f"{len(q) / dt:.1f} QPS ({len(batches)} batches, bit for "
                f"bit the resident search); promotions {d['promotions']}, "
                f"demotions {d['demotions']}, h2d {d['bytes_h2d'] / 1e9:.3f}"
                f" GB, d2h {d['bytes_d2h'] / 1e9:.3f} GB, "
                f"{res[mode]['h2d_gbs']:.2f} GB/s h2d over the run, "
                f"{res[mode]['promote_gbs']:.2f} GB/s per promotion (EMA "
                f"{eng._promote_ema * 1e3:.2f} ms), waits "
                f"{d['wait_s'] * 1e3:.1f} ms")
        res["overlap_ratio"] = res["overlap"]["qps"] / res["sync"]["qps"]
        peak = torch.cuda.max_memory_allocated() - base_mem
        limit = budget + seg_bytes + ws
        check(peak <= limit, f"(a) peak device memory {peak / 1e6:.1f} MB "
              f"above budget + one segment + working set "
              f"{limit / 1e6:.1f} MB")
        res["peak_mb"] = peak / 1e6
        log(f"[tiered] (a) overlap / sync QPS {res['overlap_ratio']:.3f}; "
            f"peak device memory of the engine {peak / 1e6:.1f} MB <= "
            f"budget + one segment + working set {limit / 1e6:.1f} MB")
        for k in ("maxsim_scan", "maxsim_rerank"):
            check(counts[k] > 0, f"(a) the tiered search never launched {k}")

        # (b) a hot scope of 2 segments
        b0 = tracing.trace_count()
        for _ in range(2):
            eng.search(*batches[0], stages=two, scope=hot)
        st0 = dict(eng.stats)
        got, dt = timed(lambda: counted(lambda: [
            eng.search(bq, bm, stages=two, scope=hot)
            for bq, bm in batches]))
        for b, (g, o) in enumerate(zip(got, scoped[hot])):
            same_result(g, o, f"(b) hot scope batch {b}")
        promos = eng.stats["promotions"] - st0["promotions"]
        check(promos == 0, f"(b) hot scope promoted {promos} segments "
              "after warm-up")
        res["hot"] = dict(qps=len(q) / dt, resident_qps=len(q) / dt_hot_res)
        log(f"[tiered] (b) hot scope {hot}: {len(q) / dt:.1f} QPS, 0 "
            f"promotions after warm-up; resident search over the same "
            f"{len(hot) * per} pages (one segment) {len(q) / dt_hot_res:.1f}"
            f" QPS (ratio {dt_hot_res / dt:.3f})")

        # (c) scopes alternating hot and cold: churn, no build
        st0 = dict(eng.stats)
        for b, (bq, bm) in enumerate(batches):
            sc = scopes[b % len(scopes)]
            g = counted(lambda: eng.search(bq, bm, stages=two, scope=sc))
            same_result(g, scoped[sc][b], f"(c) scope {sc} batch {b}")
        builds = tracing.trace_count() - b0
        check(builds == 0, f"(c) {builds} builds after warm-up: "
              f"{tracing.traced_names(since=b0)}")
        churn = eng.stats["promotions"] - st0["promotions"]
        check(churn > 0, "(c) alternating scopes never promoted")
        # the whole corpus behind a compute stream that lags the host by
        # ~0.1 s: each search demotes segments whose scans are still
        # queued, so a freed block reused under a queued kernel (no
        # record_stream, no demotion waiting for the compute stream)
        # would show here as a wrong score. The query and the packed
        # filter are on the card before the sleep: an upload inside the
        # search would wait for the sleep and end the lag
        fs = as_filter_arrays(None, r8.store.filter_words, dev)
        for b, (bq, bm) in enumerate(batches[:3]):
            qd, md = (torch.as_tensor(x).to(dev) for x in (bq, bm))
            torch.cuda._sleep(LAG_CYCLES)
            g = counted(lambda: eng.search(qd, md, stages=two, filter=fs))
            same_result(g, oracle[b], f"(c) lagging compute stream, "
                        f"batch {b}")
        log(f"[tiered] (c) scopes {scopes} over {len(batches)} batches: "
            f"bit for bit, {churn} promotions, builds 0 since (b); the "
            f"whole corpus behind a {LAG_CYCLES:.0e}-cycle sleep on the "
            f"compute stream: {len(batches[:3])} batches bit for bit")

        # (d) a deadline below one promotion: degraded and exact, or exact
        deadline = 0.5 * eng._promote_ema * 1e3
        before = eng.resident()
        scanned = tuple(s for s in range(n_segs) if s in before)
        n_deg = shared = 0
        for b, (bq, bm) in enumerate(batches):
            g = counted(lambda: eng.search(bq, bm, stages=two,
                                           deadline_ms=deadline,
                                           degrade=DegradePolicy()))
            if not g.degraded:
                same_result(g, oracle[b], f"(d) undegraded batch {b}")
                continue
            n_deg += 1
            check(g.skipped_segments == n_segs - len(scanned),
                  f"(d) skipped {g.skipped_segments}, resident {before}")
            same_result(g, eng.search(bq, bm, stages=two, scope=scanned),
                        f"(d) degraded batch {b} vs the scanned segments")
            ws_, wi = oracle[b]
            ws_ = ws_.cpu()
            gs = g.scores.cpu()
            for row in range(len(bq)):
                live = [p for p in g.ids[row] if p >= 0]
                check(all(p // per in scanned for p in live),
                      f"(d) degraded id outside the scanned segments")
                for j, p in enumerate(g.ids[row]):
                    hit = np.flatnonzero(wi[row] == p)
                    if p >= 0 and hit.size:
                        shared += 1
                        check(gs[row, j].item() == ws_[row, hit[0]].item(),
                              f"(d) id {p}: degraded score != the oracle's")
        check(n_deg > 0, "(d) no result degraded under a deadline below "
              "one promotion")
        check(shared > 0, "(d) no degraded id in the oracle's top 10")
        g = eng.search(*batches[0], stages=two, deadline_ms=60_000.0)
        check(not g.degraded, "(d) a 60 s deadline degraded")
        same_result(g, oracle[0], "(d) undegraded 60 s deadline")
        res["degraded"] = dict(deadline_ms=deadline, n=n_deg,
                               batches=len(batches))
        log(f"[tiered] (d) deadline {deadline:.3f} ms (half the promotion "
            f"EMA): {n_deg}/{len(batches)} results degraded, "
            f"{n_segs - len(scanned)} of {n_segs} segments skipped each, "
            f"scores exact (bit for bit the resident scanned segments "
            f"{scanned}, and the oracle's for each of {shared} shared "
            f"ids); a 60 s deadline is bit for bit the oracle")

        # (e) injected transfer failures, then worker deaths
        sub = batches[:3]
        for spec in ("transfer_fail_rate=0.05,seed=7",
                     "kill_worker_at=0+5+11,seed=7"):
            eng.arm(FaultPlan.parse(spec))
            st0 = dict(eng.stats)
            got = counted(lambda: [eng.search(bq, bm, stages=two)
                                   for bq, bm in sub])
            for b, g in enumerate(got):
                same_result(g, oracle[b], f"(e) {spec} batch {b}")
            d = {k: eng.stats[k] - st0[k] for k in
                 ("retries", "worker_restarts", "transfer_errors")}
            want = "retries" if "fail" in spec else "worker_restarts"
            check(d[want] >= 1, f"(e) {spec}: {d}")
            res[f"faults:{spec}"] = d
            log(f"[tiered] (e) FaultPlan {spec}: {len(sub)} batches bit for "
                f"bit, {d}")
        eng.arm(None)

        # (f) snapshot (segments on both tiers) and restore
        snap_root = Path(__file__).resolve().parent / "build"
        snap_root.mkdir(exist_ok=True)
        snap = tempfile.mkdtemp(prefix="tiered_snapshot_", dir=snap_root)
        try:
            path, dt_w = timed(lambda: eng.snapshot(snap, keep=1))
            r2, dt_r = timed(lambda: Retriever.from_snapshot(snap,
                                                             device=dev))
            for b, (bq, bm) in enumerate(batches):
                s2, i2 = r2.search(bq, bm, stages=two)
                check(bool(torch.equal(s2, oracle[b][0]))
                      and np.array_equal(i2, oracle[b][1]),
                      f"(f) restored store: batch {b} != the oracle")
            del r2
            res["snapshot"] = dict(write_gbs=total / dt_w / 1e9,
                                   restore_gbs=total / dt_r / 1e9)
            from repro_torch.training.checkpoint import load_meta
            names = load_meta(snap)["leaf_names"]
            leaf = names.index("seg3/initial")
            flip_leaf_bit(path, leaf)
            try:
                Retriever.from_snapshot(snap, device=dev)
                fail("(f) a bit flipped on disk restored without error")
            except CheckpointCorrupt as e:
                check("'seg3/initial'" in str(e),
                      f"(f) CheckpointCorrupt does not name the leaf: {e}")
            log(f"[tiered] (f) snapshot of {total / 1e9:.3f} GB (3 "
                f"segments on the card, 5 on the host tier) written in "
                f"{dt_w:.2f} s ({total / dt_w / 1e9:.2f} GB/s), restored "
                f"in {dt_r:.2f} s ({total / dt_r / 1e9:.2f} GB/s), every "
                f"batch bit for bit; a bit flipped on disk in leaf "
                f"seg3/initial: CheckpointCorrupt names it")
        finally:
            shutil.rmtree(snap, ignore_errors=True)
    finally:
        eng.close()
    check(not eng._worker.is_alive(), "tiering worker still running")
    del eng, r8, oracle, scoped

    # (g) an int8 store: int8 mean_pooling (db scan, chunk 256) and int8
    # initial (int8 rerank), float copies dropped, 8 segments, 3 resident
    two8 = MST.with_rerank_policy(MST.with_scan_policy(
        MST.two_stage(256, 10), use_kernel=True, chunk=256),
        rerank_kernel=True)
    q8 = quantize_store(base, names=("mean_pooling", "initial"),
                        stages=(MST.Stage("initial", 10),))
    check("initial" not in q8.vectors and "mean_pooling" not in q8.vectors,
          "int8 store kept a float copy")
    r8 = eight_segments(q8.vectors)
    del q8
    seg8 = r8.store.segments[0].nbytes
    oracle8 = [r8.search(bq, bm, stages=two8) for bq, bm in batches]
    eng = r8.tiered(3 * seg8)
    try:
        c0 = dict(counts)
        got, dt = timed(lambda: counted(lambda: [
            eng.search(bq, bm, stages=two8) for bq, bm in batches]))
        for b, (g, o) in enumerate(zip(got, oracle8)):
            same_result(g, o, f"(g) int8 batch {b}")
        for k in ("maxsim_scan_db", "maxsim_rerank_int8"):
            check(counts[k] > c0[k], f"(g) the int8 tiered search never "
                  f"launched {k}")
        res["int8"] = dict(qps=len(q) / dt, seg_mb=seg8 / 1e6,
                           promotions=eng.stats["promotions"])
        log(f"[tiered] (g) int8 store ({seg8 / 1e6:.1f} MB a segment, "
            f"budget 3): {len(q) / dt:.1f} QPS, bit for bit its resident "
            f"search; {eng.stats['promotions']} promotions")
    finally:
        eng.close()
    del eng, r8
    res["counts"] = counts
    log(f"[tiered] launches over the tiered searches {used(counts)}")
    return res


# ---------------------------------------------------------------------------
# phase 4p: the retrieval mesh path, 4 shards on one card
# ---------------------------------------------------------------------------

MESH_SHARDS = 4
MESH_RAGGED = dict(cut=3, ingest=64, delete=10)   # 4093 + 64 - 10 pages


def same_ranking(got, want, what: str) -> int:
    """Two rankings (scores tensor, ids) with every score equal bit for bit
    and the ids equal except where equal scores sit side by side (an
    exact tie, ordered by segment and shard on a mesh, by candidate on one
    device). Returns the exact-tie swaps."""
    gs, gi = got
    ws, wi = want
    check(bool(torch.equal(gs, ws)), f"{what}: scores differ")
    ws = ws.float().cpu().numpy()
    swaps = 0
    for r in range(len(gi)):
        m, j = row_swaps(gi[r], wi[r], ws[r], 0.0)
        check(j is None, f"{what}: row {r} rank {j} id {gi[r][j]} != "
              f"{wi[r][j] if j is not None else ''} without a tie")
        swaps += m
    return swaps


def exact_rankings(ids, sc, ref_ids, ref_sc, what: str) -> int:
    """``compare_rankings`` held to bit for bit: the top-k scores equal
    the reference's ranked one deeper (``plus_one``) bit for bit, and the
    ids equal but where equal scores sit side by side (an exact tie, the
    k-th with the (k+1)-th included). Returns the exact-tie swaps."""
    swaps = compare_rankings(ids, sc, ref_ids, ref_sc, what, tie=0.0)
    got, want = sc, ref_sc[:, :sc.shape[1]]
    check(np.array_equal(got, want), f"{what}: scores not bit for bit (max "
          f"abs difference {np.abs(got - want).max():.3e})")
    return swaps


def overcommit_and_place(args, dev, bench, r4, got_b, kern, counted, rows,
                         n: int) -> dict:
    """4p (f): the 2-stage cascade on the 4 shards at ``rerank_overcommit``
    1, 2 and 8 (retrievers sharing (b)'s placed store). At 8: (b)'s
    result bit for bit. At 1 and 2: every query row whose 256 stage-0
    candidates no shard owns more than ``cap_slots = 64 * overcommit`` of
    gives overcommit 8's ids and scores bit for bit; the other rows'
    count, recall@10 against overcommit 8, NDCG@10, QPS and the per-shard
    rerank kernel ms at ``cap_slots`` rows are printed. Then a store held
    with ``place=False`` (the same upserts, split over the mesh on each
    call) gives the placed search's results bit for bit."""
    from repro_torch.core import multistage as MST
    from repro_torch.data.synthetic import evaluate_ranking
    from repro_torch.kernels.maxsim import ops as KOPS
    from repro_torch.retrieval.retriever import Retriever

    S, B = MESH_SHARDS, args.batch
    mesh, cap = r4.mesh, r4.store.capacities[0]
    n_local = cap // S
    two = kern(MST.two_stage(256, 10))
    q, qm = bench.queries, bench.query_mask
    # stage 0's 256 candidates per query (slot ids), and how many of them
    # each shard owns
    cand = np.concatenate([
        r4.search(q[i:i + B], qm[i:i + B], stages=(two[0],),
                  translate_ids=False)[1].cpu().numpy()
        for i in range(0, len(q), B)])
    check(bool((cand >= 0).all()), "(f) a stage-0 candidate is filler")
    owned = np.stack([(cand // n_local == r).sum(1) for r in range(S)], 1)
    ids8, sc8 = got_b[2]
    out = {"owned_max": int(owned.max()), "owned_min": int(owned.min())}
    qb = torch.as_tensor(q[:B]).to(dev)
    mb = torch.as_tensor(qm[:B]).to(dev)
    slab0 = r4.store.segments[0].slabs[0]
    c0 = torch.as_tensor(cand[:B]).to(dev)
    mine = c0 // n_local == 0
    order = torch.sort((~mine).to(torch.uint8), dim=1, stable=True)[1]
    rsel = torch.gather(c0 % n_local, 1, order)
    ok = torch.gather(mine, 1, order)
    for oc in (8, 2, 1):
        r = Retriever(r4.store, mesh=mesh, rerank_overcommit=oc)
        ids, sc, dt, nq = counted(lambda: run_cascade(r, bench, two, B))
        cap_slots = min(256, 64 * oc)
        keep = owned.max(1) <= cap_slots
        for i in np.flatnonzero(keep):
            check(np.array_equal(ids[i], ids8[i])
                  and np.array_equal(sc[i], sc8[i]),
                  f"(f) overcommit {oc}: query {i} drops nothing but "
                  "differs from overcommit 8")
        drop = np.flatnonzero(~keep)
        recall = (float(np.mean([len(set(ids[i]) & set(ids8[i])) / 10
                                 for i in drop])) if len(drop) else 1.0)
        m = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
        kms = time_ms(lambda: KOPS.maxsim_rerank(
            qb, slab0["initial"], rsel[:, :cap_slots], mb,
            slab0["initial_mask"], ok[:, :cap_slots]))
        out[oc] = dict(qps=nq / dt, n_drop=len(drop), recall=recall,
                       ndcg=m["ndcg@10"], rerank_ms=kms, cap_slots=cap_slots)
        log(f"[mesh] (f) rerank_overcommit={oc} (cap_slots {cap_slots} of "
            f"256): QPS {nq / dt:.1f}; {len(keep) - len(drop)} rows that "
            "drop nothing == overcommit 8 bit for bit (ids and scores); "
            f"{len(drop)} rows drop owned candidates: recall@10 vs "
            f"overcommit 8 {recall:.4f}; ndcg@10={m['ndcg@10']:.4f}; "
            f"per-shard rerank kernel [{B}, {cap_slots}] on a slab "
            f"{kms:.3f} ms")
        if oc == 8:
            check(np.array_equal(ids, ids8) and np.array_equal(sc, sc8),
                  "(f) overcommit 8 != (b)'s 2-stage result bit for bit")
        del r
    log(f"[mesh] (f) stage-0 candidates a shard owns per query: "
        f"{out['owned_min']}..{out['owned_max']} of 256")

    # a store held with place=False: (b)'s upserts, never laid out
    ru = Retriever(rows(0, 0), capacity=cap, mesh=mesh, filter_words=2,
                   place=False)
    for lo, hi, tenant, tags in tenant_groups(n):
        ru.upsert(rows(lo, hi), tenant=tenant, tags=tags)
    check(ru.store.mesh is None
          and all(len(sg.slabs) == 1 for sg in ru.store.segments),
          "(f) the place=False store was laid out on the mesh")
    check(ru.store.capacities == r4.store.capacities,
          f"(f) place=False capacities {ru.store.capacities}")
    for ns in (1, 2):
        st = kern(MST.one_stage(10)) if ns == 1 else two
        ids, sc, dt, nq = counted(lambda: run_cascade(ru, bench, st, B))
        check(np.array_equal(ids, got_b[ns][0])
              and np.array_equal(sc, got_b[ns][1]),
              f"(f) place=False {ns}-stage != the placed search bit for "
              "bit")
        out[f"unplaced {ns}"] = nq / dt
        log(f"[mesh] (f) place=False {ns}-stage on {S} shards (split on "
            f"each call): QPS {nq / dt:.1f}; == the placed search bit for "
            "bit")
    del ru
    return out


def mesh_path(args, dev, main, int8, filt, routed) -> dict:
    """Phase 4p: the phase-4 corpus on a mesh of 4 shards of this card
    (``make_mesh((4,), ("data",), devices=["cuda:0"] * 4)``), held against
    the single-device kernel path of this run. (a) a 1-position mesh
    equals ``mesh=None`` bit for bit; (b) 4 shards: the 1-, 2- and 3-stage
    cascades, int8 (db scan, ``scan_topk``, int8 rerank), a tenant filter
    and routed search (full probe and ``n_probe`` 8) give the single-device
    scores bit for bit, its ids apart from exact ties and phase 4's
    NDCG@10 to 3 decimals; (c) a ragged corpus (4093 pages, 64 ingested,
    10 deleted) equals a single-device store rebuilt from the survivors
    in the same way, no page twice in a
    row when k exceeds the live candidates, 0 builds after warm-up; (d) 8
    segments behind a ``TieredEngine`` with a budget of 3 equal the
    resident mesh search bit for bit, and a snapshot restores onto the
    mesh and onto one device; (e) QPS, per-shard kernel ms, peak
    memory. Only the mesh's own runs count launches."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core import multistage as MST
    from repro_torch.data.synthetic import evaluate_ranking
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.kernels.maxsim import ops as KOPS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.retrieval import tracing
    from repro_torch.retrieval.ingest import IngestPipeline
    from repro_torch.retrieval.retriever import Retriever
    from repro_torch.retrieval.routing import RoutingPolicy
    from repro_torch.retrieval.segments import bucket_capacity
    from repro_torch.retrieval.store import (FilterSpec, VectorStore,
                                             is_store_companion)

    t_phase = time.perf_counter()
    S = MESH_SHARDS
    bench = main["bench"]
    base = base_store(main)
    n = base.n_docs
    B = args.batch
    q, qm = bench.queries, bench.query_mask
    batches = [(q[i:i + B], qm[i:i + B]) for i in range(0, len(q), B)]
    mesh = make_mesh((S,), ("data",), devices=[dev] * S)
    mesh1 = make_mesh((1,), ("data",), devices=[dev])
    cap = bucket_capacity(args.pages, S)
    counts = {k: 0 for k in DSP.KERNELS}

    def counted(fn):
        """Run ``fn`` (a mesh run) with the launch counters zeroed before
        and added to this phase's counts after."""
        DSP.reset_counts()
        out = fn()
        for k in DSP.KERNELS:
            counts[k] += DSP.launch_count(k)
        return out

    def kern(stages, **scan):
        return MST.with_rerank_policy(MST.with_scan_policy(
            stages, use_kernel=True, **scan), rerank_kernel=True)

    def rows(lo, hi, vecs=base.vectors):
        return VectorStore({k: v[lo:hi] for k, v in vecs.items()}, hi - lo)

    cascades = {1: MST.one_stage(10), 2: MST.two_stage(256, 10),
                3: MST.three_stage(1024, 256, 10)}
    res = {"qps": {}, "swaps": {}}
    log(f"[mesh] {mesh}: {S} shards time-sliced on one card, slabs of "
        f"{cap // S} slots; the single-device kernel path of this run is "
        "the reference")

    # (a) a 1-position mesh: mesh=None's results bit for bit
    r1 = Retriever(base, capacity=cap, mesh=mesh1)
    for ns, st in cascades.items():
        ids, sc, dt, nq = counted(lambda: run_cascade(r1, bench, kern(st),
                                                      B))
        want = main["results"][ns]
        check(np.array_equal(ids, want["ids"])
              and np.array_equal(sc, want["scores"]),
              f"(a) 1-position mesh {ns}-stage != mesh=None bit for bit")
        res["qps"][(1, ns)] = nq / dt
    del r1
    log("[mesh] (a) 1-position mesh: the 1-, 2- and 3-stage kernel "
        "cascades equal mesh=None bit for bit (ids and scores); QPS "
        + ", ".join(f"{ns}-stage {res['qps'][(1, ns)]:.1f}"
                    for ns in cascades))

    # (b) 4 shards: phase 4c's tenants and tags, so one store serves the
    # unfiltered, filtered and (below) routed checks
    t0 = time.perf_counter()
    r4 = Retriever(rows(0, 0), capacity=cap, mesh=mesh, filter_words=2)
    for lo, hi, tenant, tags in tenant_groups(n):
        r4.upsert(rows(lo, hi), tenant=tenant, tags=tags)
    torch.cuda.synchronize()
    check(r4.store.capacities == (cap,) and r4.store.n_shards == S
          and len(r4.store.segments[0].slabs) == S,
          f"(b) 4-shard store: capacities {r4.store.capacities}")
    log(f"[mesh] (b) {n} pages upserted onto {S} slabs in groups of 64 "
        f"(4c's tenants and tags) in {time.perf_counter() - t0:.2f}s")
    single = main["retriever"]
    got_b = {}
    for ns, st in cascades.items():
        ref_ids, ref_sc, _, _ = run_cascade(single, bench,
                                            plus_one(kern(st)), B)
        ids, sc, dt, nq = counted(lambda: run_cascade(r4, bench, kern(st),
                                                      B))
        got_b[ns] = (ids, sc)
        swaps = exact_rankings(ids, sc, ref_ids, ref_sc,
                               f"(b) 4 shards {ns}-stage vs one device")
        m = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
        want = main["results"][ns]["metrics"]
        check(abs(m["ndcg@10"] - want["ndcg@10"]) < 5e-4,
              f"(b) {ns}-stage ndcg@10 {m['ndcg@10']:.4f} != phase 4's "
              f"{want['ndcg@10']:.4f} to 3 decimals")
        res["qps"][(S, ns)] = nq / dt
        res["swaps"][ns] = swaps
        log(f"[mesh] (b) {ns}-stage on {S} shards: QPS {nq / dt:.1f} (one "
            f"device {main['results'][ns]['qps']:.1f}); ids == one device "
            f"({swaps} exact-tie swaps), scores bit for bit; "
            f"ndcg@10={m['ndcg@10']:.4f}")

    one, two = MST.one_stage(10), MST.two_stage(256, 10)
    res["f"] = overcommit_and_place(args, dev, bench, r4, got_b, kern,
                                    counted, rows, n)

    # int8: 4b's quantised stores placed on the mesh
    stores8 = {"a": int8["ra"], "b": int8["rb"]}
    cascades8 = {
        "1-stage int8 initial (db scan)": ("a", one, False),
        "2-stage bf16 pooled (db scan) + int8 rerank": ("a", two, False),
        "1-stage int8 initial scan_topk": ("a", one, True),
        "2-stage int8 pooled scan_topk + bf16 rerank": ("b", two, True),
    }
    for which in ("a", "b"):
        r8 = stores8[which]
        m8 = Retriever(VectorStore(
            {k: v[:n] for k, v in r8.store.vectors.items()
             if not is_store_companion(k)}, n),
            capacity=cap, mesh=mesh)
        for name, (w, st, topk) in cascades8.items():
            if w != which:
                continue
            st = kern(st, chunk=256, scan_topk=topk)
            ref_ids, ref_sc, _, _ = run_cascade(r8, bench, plus_one(st), B)
            ids, sc, dt, nq = counted(lambda: run_cascade(m8, bench, st, B))
            swaps = exact_rankings(ids, sc, ref_ids, ref_sc,
                                   f"(b) 4 shards {name} vs one device")
            m = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
            want = int8["results"][name]["metrics"]
            check(abs(m["ndcg@10"] - want["ndcg@10"]) < 5e-4,
                  f"(b) {name} ndcg@10 {m['ndcg@10']:.4f} != 4b's "
                  f"{want['ndcg@10']:.4f}")
            res["qps"][(S, name)] = nq / dt
            log(f"[mesh] (b) {name} on {S} shards: QPS {nq / dt:.1f} (one "
                f"device {int8['results'][name]['qps']:.1f}); ids == one "
                f"device ({swaps} exact-tie swaps), scores bit for bit; "
                f"ndcg@10={m['ndcg@10']:.4f}")
        del m8
    for k in ("maxsim_scan_db", "maxsim_scan_int8", "maxsim_rerank_int8"):
        check(counts[k] > 0, f"(b) the int8 mesh cascades never launched "
              f"{k}")

    # a tenant filter, against 4c's single-device filtered store
    spec = filt["specs"][0]
    ref_ids, ref_sc, _, _ = run_cascade(filt["retriever"], bench,
                                        plus_one(kern(two)), B, spec)
    ids, sc, dt, nq = counted(lambda: run_cascade(r4, bench, kern(two), B,
                                                  spec))
    swaps = exact_rankings(ids, sc, ref_ids, ref_sc,
                           f"(b) 4 shards filter {spec} vs one device")
    res["qps"][(S, "filter")] = nq / dt
    log(f"[mesh] (b) 2-stage {spec} on {S} shards: QPS {nq / dt:.1f}; ids "
        f"== 4c's one-device filtered search ({swaps} exact-tie swaps), "
        "scores bit for bit")

    # routed: one clustering of the whole segment, on every shard
    t0 = time.perf_counter()
    r4.store.enable_routing(RoutingPolicy(routed["n_clusters"]))
    torch.cuda.synchronize()
    t_cluster = time.perf_counter() - t0
    rs = routed["retriever"]
    for key in ("ivf_centroids", "ivf_members"):
        for slab in r4.store.segments[0].slabs:
            check(bool(torch.equal(slab[key], rs.store.vectors[key])),
                  f"(b) the mesh store's {key} differ from 4d's")
    ex_m = evaluate_ranking(run_cascade(r4, bench, kern(two), B)[0],
                            bench.qrels, ks=(5, 10))
    for n_probe in (routed["n_clusters"], 8):
        st = MST.with_routing_policy(kern(two), n_probe=n_probe,
                                     n_clusters=routed["n_clusters"])
        ref_ids, ref_sc, _, _ = run_cascade(rs, bench, plus_one(st), B)
        ids, sc, dt, nq = counted(lambda: run_cascade(r4, bench, st, B))
        swaps = exact_rankings(ids, sc, ref_ids, ref_sc,
                               f"(b) 4 shards routed n_probe={n_probe} "
                               "vs one device")
        m = evaluate_ranking(ids, bench.qrels, ks=(5, 10))
        if n_probe == routed["n_clusters"]:
            for k in m:
                check(abs(m[k] - ex_m[k]) < 5e-4, f"(b) full probe {k}: "
                      f"routed {m[k]:.4f} != exhaustive {ex_m[k]:.4f}")
        res["qps"][(S, f"routed {n_probe}")] = nq / dt
        log(f"[mesh] (b) routed 2-stage n_probe={n_probe}/"
            f"{routed['n_clusters']} on {S} shards: QPS {nq / dt:.1f}; ids "
            f"== 4d's one device ({swaps} exact-tie swaps), scores bit "
            "for bit; ndcg@10="
            f"{m['ndcg@10']:.4f}" + (" == exhaustive metrics"
                                     if n_probe == routed["n_clusters"]
                                     else ""))
    check(counts["ivf_route"] > 0, "(b) routed mesh search never launched "
          "ivf_route")
    log(f"[mesh] (b) clustering the 4-shard store: {t_cluster:.2f}s; "
        "centroids and member lists equal 4d's on every slab")

    # (e) per-shard kernels: shard 0's slab against the whole store
    qb = torch.as_tensor(q[:B]).to(dev)
    mb = torch.as_tensor(qm[:B]).to(dev)
    vec = single.store.vectors
    slab0 = r4.store.segments[0].slabs[0]
    kms = {}
    for name in ("initial", "mean_pooling"):
        kms[name] = (
            time_ms(lambda: KOPS.maxsim_scores(qb, slab0[name], mb,
                                               slab0[name + "_mask"])),
            time_ms(lambda: KOPS.maxsim_scores(qb, vec[name], mb,
                                               vec[name + "_mask"])))
    _, cand = single.search(qb, mb, stages=kern(MST.one_stage(256)),
                            translate_ids=False)
    n_local = cap // S
    mine = cand // n_local == 0
    order = torch.sort((~mine).to(torch.uint8), dim=1, stable=True)[1]
    rsel = torch.gather(cand % n_local, 1, order)
    ok = torch.gather(mine, 1, order)
    kms["rerank"] = (
        time_ms(lambda: KOPS.maxsim_rerank(qb, slab0["initial"], rsel, mb,
                                           slab0["initial_mask"], ok)),
        time_ms(lambda: KOPS.maxsim_rerank(qb, vec["initial"], cand, mb,
                                           vec["initial_mask"],
                                           torch.ones_like(ok))))
    owned = float(ok.float().mean())
    # where the 4-shard scores' last bits come from: shard 0's scans and
    # its rerank's owned candidates against the same documents on the
    # whole store (printed, not checked: both are within the kernels'
    # tolerance of the plain version)
    bits = {}
    for name in ("initial", "mean_pooling"):
        a = KOPS.maxsim_scores(qb, slab0[name], mb, slab0[name + "_mask"])
        b = KOPS.maxsim_scores(qb, vec[name][:n_local], mb,
                               vec[name + "_mask"][:n_local])
        bits[f"scan {name}"] = float((a - b).abs().max())
    a = KOPS.maxsim_rerank(qb, slab0["initial"], rsel, mb,
                           slab0["initial_mask"], ok)
    b = KOPS.maxsim_rerank(qb, vec["initial"], torch.gather(cand, 1, order),
                           mb, vec["initial_mask"], ok)
    bits["rerank owned"] = float((a - b)[ok].abs().max())
    b_all = KOPS.maxsim_rerank(qb, vec["initial"], cand, mb,
                               vec["initial_mask"], torch.ones_like(ok))
    bits["rerank owned vs unmasked"] = float(
        (a - torch.gather(b_all, 1, order))[ok].abs().max())
    peak = {}
    for label, r in (("one device", single), (f"{S} shards", r4)):
        st = kern(two)
        r.search(qb, mb, stages=st)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        r.search(qb, mb, stages=st)
        torch.cuda.synchronize()
        peak[label] = (torch.cuda.max_memory_allocated() - m0) / 1e6
    res["kernel_ms"], res["peak_mb"], res["owned"] = kms, peak, owned
    log("[mesh] (e) shard 0 against the same documents on the whole store, "
        "max abs difference: " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in bits.items()))
    log("[mesh] (e) per-shard kernels (wrapper calls, median of 10): scan "
        + "; ".join(f"{k} slab [{n_local}, ...] {a:.3f} ms vs the whole "
                    f"[{cap}, ...] {b:.3f} ms" for k, (a, b) in kms.items()
                    if k != "rerank")
        + f"; rerank [{B}, 256] on a slab {kms['rerank'][0]:.3f} ms (all "
        f"256 rows scored, {100 * owned:.1f}% owned) x {S} shards = "
        f"{S * kms['rerank'][0]:.3f} ms vs one device "
        f"{kms['rerank'][1]:.3f} ms; search peak memory above the store "
        + ", ".join(f"{k} {v:.1f} MB" for k, v in peak.items()))
    del r4, rs, cand
    filt.pop("retriever")
    routed.pop("retriever")

    # (c) a ragged corpus: 4093 pages, 64 ingested, 10 deleted
    cfg = get_config("colpali")
    pipe = IngestPipeline(cfg, device=dev)
    n0 = n - MESH_RAGGED["cut"]
    n_new, n_del = MESH_RAGGED["ingest"], MESH_RAGGED["delete"]
    total = n0 + n_new
    cap_r = -(-total // S) * S
    rr = Retriever(rows(0, n0), capacity=cap_r, mesh=mesh, ingest=pipe)
    two_k = kern(two)
    spec1 = FilterSpec(tenant=1)
    wide = kern(MST.two_stage(256, 100))
    for st in (two_k, wide):                              # warm-up
        rr.search(*batches[0], stages=st)
    torch.cuda.synchronize()
    builds = tracing.trace_count()
    new_pages = -bench.pages[:n_new]          # distinct pages, new ids
    new_ids = counted(lambda: rr.ingest(new_pages, bench.token_types,
                                        tenant=1))
    check(np.array_equal(new_ids, np.arange(n0, total)),
          f"(c) ingested ids {new_ids[:3]}...")
    dead = [5] + [int(n0 * f) for f in (0.19, 0.37, 0.5, 0.73)] + [
        n0 - 1] + [int(new_ids[j]) for j in (0, 10, 33, 63)]
    check(len(dead) == n_del and rr.delete(dead) == n_del,
          "(c) delete of 10 pages")
    ids, sc, dt, nq = counted(lambda: run_cascade(rr, bench, two_k, B))
    f_ids, f_sc, _, _ = counted(lambda: run_cascade(rr, bench, wide, B,
                                                    spec1))
    check(tracing.trace_count() == builds,
          f"(c) {tracing.trace_count() - builds} builds after warm-up")
    check(rr.store.capacities == (cap_r,), f"(c) capacities "
          f"{rr.store.capacities}")
    keep = np.setdiff1d(np.arange(total), dead)
    new = pipe.index(new_pages, bench.token_types)
    sel = torch.from_numpy(keep[keep < n0]).to(dev)
    sel_new = torch.from_numpy(keep[keep >= n0] - n0).to(dev)
    rebuilt = Retriever(VectorStore(
        {k: torch.cat([v.index_select(0, sel),
                       new.vectors[k].index_select(0, sel_new)])
         for k, v in base.vectors.items()}, len(keep)), device=dev)
    ref_ids, ref_sc, _, _ = run_cascade(rebuilt, bench, plus_one(two_k), B)
    ref_ids = np.where(ref_ids >= 0, keep[np.clip(ref_ids, 0, None)], -1)
    swaps = exact_rankings(ids, sc, ref_ids, ref_sc,
                           "(c) ragged 4 shards vs the rebuilt store")
    live_new = set(keep[keep >= n0].tolist())
    for r, row in enumerate(f_ids):
        live = row[row >= 0]
        check(len(live) == len(set(live.tolist())),
              f"(c) query {r}: a page twice in one row: {row}")
        check(set(live.tolist()) == live_new, f"(c) query {r}: the "
              f"tenant-1 rows {sorted(set(live.tolist()))[:5]}... are not "
              "the live tenant-1 pages")
        check(bool((f_sc[r][row < 0] <= NEG / 2).all()),
              f"(c) query {r}: a filler with a live score")
    res["qps"][(S, "ragged")] = nq / dt
    log(f"[mesh] (c) {n0} pages on {S} shards (capacity {cap_r}, slabs of "
        f"{cap_r // S}), {n_new} ingested (pooling kernel, tenant 1), "
        f"{n_del} deleted: 2-stage ids == a one-device store rebuilt from "
        f"the {len(keep)} survivors ({swaps} exact-tie swaps, scores bit for "
        f"bit), QPS {nq / dt:.1f}; "
        f"2-stage(256, 100) over the {len(live_new)} live tenant-1 pages: "
        f"every one once per row, the rest -1; builds after warm-up 0")
    del rr, rebuilt, new, pipe

    # (d) 8 segments of pages/8 on the mesh behind a TieredEngine
    per = n // 8
    rt = Retriever(rows(0, per), mesh=mesh)
    for lo in range(per, n, per):
        rt.upsert(rows(lo, lo + per))
    check(rt.store.capacities == (per,) * 8, f"(d) capacities "
          f"{rt.store.capacities}")
    rt.search(*batches[0], stages=two_k)                  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    oracle = counted(lambda: [rt.search(bq, bm, stages=two_k)
                              for bq, bm in batches])
    torch.cuda.synchronize()
    dt_res = time.perf_counter() - t0
    seg_bytes = rt.store.segments[0].nbytes
    with rt.tiered(3 * seg_bytes) as eng:
        check(len(eng.resident()) == 3, f"(d) budget of 3: resident "
              f"{eng.resident()}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = counted(lambda: [eng.search(bq, bm, stages=two_k)
                               for bq, bm in batches])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for b, (g, o) in enumerate(zip(got, oracle)):
            same_result(g, o, f"(d) tiered mesh batch {b}")
        promo = eng.stats["promotions"]
        check(promo > 0, "(d) the tiered mesh search promoted nothing")
        # a scope runs as one joint cascade, so it pins every segment it
        # holds: a whole-corpus scope overshoots the budget (``overflow``)
        # and stays resident, as in ``repro``
        over, held = eng.stats["overflow"], len(eng.resident())
    res["qps"][(S, "tiered")] = len(q) / dt
    res["qps"][(S, "tiered resident")] = len(q) / dt_res
    snap_root = Path(__file__).resolve().parent / "build"
    snap_root.mkdir(exist_ok=True)
    snap = tempfile.mkdtemp(prefix="mesh_snapshot_", dir=snap_root)
    try:
        rt.snapshot(snap, keep=1)
        on_mesh = Retriever.from_snapshot(snap, mesh=mesh)
        on_one = Retriever.from_snapshot(snap, device=dev)
        check(on_mesh.store.n_shards == S and on_one.store.n_shards == S
              and all(len(s.slabs) == S for s in on_mesh.store.segments)
              and all(len(s.slabs) == 1 for s in on_one.store.segments),
              "(d) restored stores: shards and placement")
        swaps = 0
        for b, (bq, bm) in enumerate(batches):
            a = on_mesh.search(bq, bm, stages=two_k)
            same_result(a, oracle[b], f"(d) restored on the mesh, batch {b}")
            swaps += same_ranking(on_one.search(bq, bm, stages=two_k), a,
                                  f"(d) restored on one device, batch {b}")
        del on_mesh, on_one
    finally:
        shutil.rmtree(snap, ignore_errors=True)
    log(f"[mesh] (d) {len(rt.store.segments)} segments of {per} pages "
        f"({seg_bytes / 1e6:.1f} MB each) on {S} shards, budget 3: tiered "
        f"{len(q) / dt:.1f} QPS (resident {len(q) / dt_res:.1f}), bit for "
        f"bit the resident mesh search, {promo} promotions, {held} segments resident after (the joint "
        f"cascade pins its whole scope: {over} budget overflows); a "
        f"snapshot restored onto the mesh answers bit "
        f"for bit, restored onto one device the same scores bit for bit and "
        f"ids ({swaps} exact-tie swaps)")
    del rt, oracle, got

    for k in ("maxsim_scan", "maxsim_rerank", "pooling", "maxsim_scan_db",
              "maxsim_scan_int8", "maxsim_rerank_int8", "ivf_route"):
        check(counts[k] > 0, f"kernel {k} was never launched on the mesh "
              "path")
    res["counts"] = counts
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[mesh] launches over the mesh runs {used(counts)}; phase 4p "
        f"{res['seconds']:.1f}s")
    return res


# ---------------------------------------------------------------------------
# phase 4k: the encoder and its training path
# ---------------------------------------------------------------------------

def load_example(name: str):
    """An ``examples/<name>.py`` module (its ``main`` is not run)."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_step_flops(cfg, B: int, Q: int) -> tuple:
    """(FLOPs of one contrastive train step, the formula): 2 x
    multiply-adds of the forward pass, the per-block recompute and the
    backward pass (2 x forward) over B pages of S tokens and B queries of
    Q tokens."""
    d, L, S = cfg.d_model, cfg.n_layers, cfg.seq_len
    T = B * (S + Q)
    blocks = L * (T * (4 * d * d + 2 * d * cfg.d_ff)
                  + 2 * B * (S * S + Q * Q) * d)
    fwd = (blocks + T * d * cfg.out_dim + B * cfg.n_patches * 64 * d
           + B * B * Q * S * cfg.out_dim)
    formula = ("2 x (3 x fwd + blocks) multiply-adds; blocks = L x [T x "
               "(4 d^2 + 2 d d_ff) + 2 B (S^2 + Q^2) d], T = B (S + Q); fwd "
               "= blocks + T d out + B n_patches 64 d + B^2 Q S out "
               f"(L={L}, d={d}, d_ff={cfg.d_ff}, S={S}, Q={Q}, B={B})")
    return 2.0 * (3 * fwd + blocks), formula


PROFILE_TRIES = 3


def profiled(fn) -> tuple:
    """(``fn()``, the device events of one call under ``torch.profiler``
    with CUDA activity). The profiler has recorded no device event for
    a call on the card now and then; such a call is run and profiled
    again, up to ``PROFILE_TRIES`` times in all, and the caller's check
    fails if none of them recorded any."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if str(e.device_type).endswith("CUDA")]
        if sum(e.device_time for e in events) > 0:
            break
        log(f"[profile] torch.profiler recorded no device time (try "
            f"{attempt} of {PROFILE_TRIES})")
    return out, events


def profile_device_time(fn) -> tuple:
    """(``fn()``, device milliseconds of its kernels by kind): one call
    under ``torch.profiler`` (``profiled``), each device event counted
    once, GEMM kernels (cuBLAS's ``gemm``/``xmma`` and Hopper ``nvjet``
    kernels; a CUTLASS kernel counts when its name says ``gemm``),
    softmax kernels and the rest."""
    out, events = profiled(fn)
    by_kind = {"gemm": 0.0, "softmax": 0.0, "other": 0.0}
    for e in events:
        name = e.name.lower()
        kind = ("gemm" if any(t in name for t in GEMM_NAMES) else
                "softmax" if "softmax" in name else "other")
        by_kind[kind] += e.device_time / 1e3
    check(sum(by_kind.values()) > 0, "torch.profiler recorded no device "
          "time")
    return out, by_kind


GEMM_NAMES = ("gemm", "xmma", "nvjet")


def busy_line(by_kind: dict, wall_ms: float) -> str:
    busy = sum(by_kind.values())
    return (f"device kernel time {busy:.1f} ms ({100 * busy / wall_ms:.1f}% "
            f"of {wall_ms:.1f} ms): " + ", ".join(
                f"{k} {v:.1f} ms ({100 * v / busy:.1f}%)"
                for k, v in by_kind.items()))


def grads_of(model) -> dict:
    return {n: p.grad for n, p in model.named_parameters()}


def train_path(args, dev) -> dict:
    """The ColX encoder and its training path at ColPali width: (a) loss
    and every gradient of a 2-layer model on the card against the CPU,
    (b) training steps at the full 16-layer config, timed, (c) checkpoint
    and resume, (d) the trained encoder's pages indexed through the
    pooling kernel and searched through the scan and rerank kernels
    against the plain path."""
    import copy
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core import multistage as MST
    from repro_torch.data.synthetic import evaluate_ranking
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.models import late_interaction as LI
    from repro_torch.retrieval.ingest import IngestPipeline
    from repro_torch.retrieval.retriever import Retriever
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train_state as TS
    from repro_torch.training.train_loop import make_train_step

    ex = load_example("train_retriever_torch")
    full = get_config("colpali")
    rng = np.random.default_rng(args.seed)
    DSP.reset_counts()
    res = {}

    # (a) card against CPU: one seeded 2-layer model, one batch
    cfg2 = dataclasses.replace(full, n_layers=2)
    cpu = LI.init_params(cfg2, torch.Generator().manual_seed(0),
                         device="cpu")
    gpu = copy.deepcopy(cpu).to(dev)
    batch = ex.synth_batch(rng, cfg2, 4)
    t0 = time.perf_counter()
    loss_c = cpu.contrastive_loss(batch)
    loss_c.backward()
    t_cpu = time.perf_counter() - t0
    loss_g = gpu.contrastive_loss(batch)
    loss_g.backward()
    torch.cuda.synchronize()
    lc, lg = loss_c.item(), loss_g.item()
    gc, gg = grads_of(cpu), grads_of(gpu)
    check(np.isfinite(lg) and abs(lg - lc) <= 1e-5 * abs(lc),
          f"(a) card loss {lg!r} != CPU loss {lc!r} (rtol 1e-5)")
    gn_c = float(OPT.global_norm(gc.values()))
    gn_g = float(OPT.global_norm(gg.values()))
    worst, worst_rel, worst_name = 0.0, 0.0, ""
    for n, g in gc.items():
        got = gg[n].cpu()
        check(bool(torch.isfinite(got).all()), f"(a) grad {n} not finite")
        try:
            torch.testing.assert_close(got, g, rtol=1e-3, atol=1e-6)
        except AssertionError as e:
            fail(f"(a) grad {n}: card != CPU (rtol 1e-3, atol 1e-6): {e}")
        err = float((got - g).abs().max())
        scale = float(g.abs().max())
        rel = err / scale if scale > 0 else 0.0
        if err > worst:
            worst = err
        if rel > worst_rel:
            worst_rel, worst_name = rel, n
    log(f"[train] (a) {cfg2.n_layers}-layer ColPali width (d {cfg2.d_model}, "
        f"S {cfg2.seq_len}), batch 4, card vs CPU: loss "
        f"{lg:.7f} vs {lc:.7f} (rel err {abs(lg - lc) / abs(lc):.3e}, rtol "
        f"1e-5); grad_norm {gn_g:.7f} vs {gn_c:.7f}; {len(gc)} grad leaves "
        f"within rtol 1e-3, atol 1e-6: max abs err {worst:.3e}, largest "
        f"err / max|grad| of a leaf {worst_rel:.3e} ({worst_name}); CPU "
        f"fwd+bwd {t_cpu:.1f}s")
    res["a"] = dict(loss_rel=abs(lg - lc) / abs(lc), grad_abs=worst,
                    grad_rel_to_max=worst_rel)
    del cpu, gpu, gc, gg, loss_c, loss_g

    # (b) the full 16-layer config, batch 16
    B, n_warm, n_timed, n_prof, n_after = 16, 2, 10, 1, 2
    model = LI.init_params(full, torch.Generator().manual_seed(1), dev)
    params = dict(model.named_parameters())
    labels = OPT.default_labels(params)
    oc = OPT.OptConfig(lr=3e-4, warmup=20)
    opt = OPT.init_opt_state(params, labels)
    step_fn = make_train_step(lambda m, b: m.contrastive_loss(b), oc,
                              labels=labels)
    batches = [{k: v.to(dev) for k, v in
                ex.synth_batch(rng, full, B).items()}
               for _ in range(n_warm + n_timed + n_prof + n_after)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, times = [], []
    for i in range(n_warm + n_timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics.append(step_fn(model, opt, batches[i]))
        end.record()
        end.synchronize()
        if i >= n_warm:
            times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times)
    m_prof, by_kind = profile_device_time(
        lambda: step_fn(model, opt, batches[n_warm + n_timed]))
    metrics.append(m_prof)
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    lrs = torch.stack([m["lr"] for m in metrics]).cpu()
    want_lr = OPT.make_schedule(oc)(torch.arange(
        1, len(metrics) + 1, dtype=torch.int32, device=dev)).cpu()
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"(b) non-finite loss or grad_norm: {losses} {gnorms}")
    check(bool(torch.equal(lrs, want_lr)), f"(b) lr sequence {lrs.tolist()}"
          f" != the schedule {want_lr.tolist()}")
    flops, formula = train_step_flops(full, B, batches[0]["query_tokens"]
                                      .shape[1])
    tflops = flops / (ms / 1e3) / 1e12
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] (b) ColPali ({full.n_layers} layers, d {full.d_model}, S "
        f"{full.seq_len}), "
        f"{n_params / 1e6:.1f}M params, batch {B}, "
        f"OptConfig(lr=3e-4, warmup=20): {n_warm} warm-up + {n_timed} "
        f"timed + {n_prof} profiled steps; median {ms:.1f} ms/step (min {min(times):.1f}, max "
        f"{max(times):.1f}), {B / (ms / 1e3):.1f} pages/s; losses "
        + " ".join(f"{x:.4f}" for x in losses) + "; grad_norms "
        + " ".join(f"{x:.4f}" for x in gnorms) + f"; lr == schedule at "
        f"steps 1-{len(metrics)} ({float(lrs[-1]):.3e} at the last)")
    log(f"[train] (b) {flops:.4e} FLOPs per step = {formula}; "
        f"{tflops:.2f} TFLOP/s, {100 * tflops / (F32_FLOPS_PER_S / 1e12):.1f}"
        f"% of the f32 rate ({F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s, TF32 "
        f"off); peak device memory {peak / 1e9:.2f} GB "
        "(max_memory_allocated)")
    busy = sum(by_kind.values())
    log(f"[train] (b) one more step under torch.profiler: device kernel "
        f"time {busy:.1f} ms ({100 * busy / ms:.1f}% of the median "
        "unprofiled step): " + ", ".join(
            f"{k} {v:.1f} ms ({100 * v / busy:.1f}%)"
            for k, v in by_kind.items()))
    res["b"] = dict(ms=ms, pages_s=B / (ms / 1e3), flops=flops,
                    tflops=tflops, peak_gb=peak / 1e9, losses=losses)

    # (c) checkpoint after the last timed step, resume in a fresh model
    k = len(metrics) - 1
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="train_ckpt_", dir=root)
    try:
        saved = [x.clone() for x in TS.leaves(model, opt)]
        nbytes = sum(x.numel() * x.element_size() for x in saved)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        TS.save(ckpt, k, model, opt, keep=1)
        t_w = time.perf_counter() - t0
        cont = [float(step_fn(model, opt, b)["loss"])
                for b in batches[len(metrics):]]
        del model, opt, params
        fresh = LI.init_params(full, torch.Generator().manual_seed(2), dev)
        fopt = OPT.init_opt_state(dict(fresh.named_parameters()), labels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = TS.restore(ckpt, fresh, fopt)
        torch.cuda.synchronize()
        t_r = time.perf_counter() - t0
        check(meta["step"] == k, f"(c) restored step {meta['step']} != {k}")
        back = TS.leaves(fresh, fopt)
        check(len(back) == len(saved) and all(
            a.device == b.device and a.dtype == b.dtype
            and torch.equal(a, b) for a, b in zip(back, saved)),
            "(c) restored train state != the saved one bit for bit")
        del back, saved
        resumed = [float(step_fn(fresh, fopt, b)["loss"])
                   for b in batches[len(metrics):]]
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(resumed, cont)]
    check(max(rel) <= 1e-5, f"(c) resumed losses {resumed} != "
          f"uninterrupted {cont} (rtol 1e-5)")
    log(f"[train] (c) checkpoint of {nbytes / 1e9:.3f} GB (params + m + v "
        f"+ step, {len(TS.leaf_names(fresh, fopt))} leaves in repro's "
        f"order) after step {k + 1}: write {nbytes / 1e9 / t_w:.2f} GB/s "
        f"({t_w:.1f}s), restore onto the card {nbytes / 1e9 / t_r:.2f} GB/s "
        f"({t_r:.1f}s), bit for bit; next {len(cont)} losses resumed "
        + " ".join(f"{x:.6f}" for x in resumed) + " vs uninterrupted "
        + " ".join(f"{x:.6f}" for x in cont)
        + f" (max rel err {max(rel):.2e}, rtol 1e-5)")
    res["c"] = dict(gb=nbytes / 1e9, write_gbs=nbytes / 1e9 / t_w,
                    restore_gbs=nbytes / 1e9 / t_r, rel=max(rel))
    del batches

    # (d) encode 512 pages and their queries, index, search
    n_pages, enc_b = 512, 64
    fresh.eval()
    data = ex.synth_batch(rng, full, n_pages)
    patches = data["patches"].to(dev)
    with torch.no_grad():
        fresh.encode_pages(patches[:enc_b])            # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pages = [fresh.encode_pages(patches[i:i + enc_b])
                 for i in range(0, n_pages, enc_b)]
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        qv = fresh.encode_queries(data["query_tokens"], data["query_mask"])
    del patches
    types = pages[0][1]
    check(all(tuple(v.shape) == (enc_b, full.seq_len, full.out_dim)
              and bool(torch.isfinite(v).all()) for v, _ in pages),
          "(d) encoded pages: wrong shape or non-finite")
    check(bool(torch.isfinite(qv).all()), "(d) query vectors not finite")
    pipe = IngestPipeline.for_config(full, device=dev)
    r = Retriever(pipe.index(pages[0][0], types), capacity=n_pages,
                  device=dev, ingest=pipe)
    ids = list(range(enc_b))
    for v, t in pages[1:]:
        ids += list(r.ingest(v, t))
    del pages
    check(r.n_docs == n_pages, f"(d) {r.n_docs} pages indexed")
    qrels = [{int(ids[i]): 1} for i in range(n_pages)]
    qb = query_set(qv, data["query_mask"].to(dev))
    two = MST.two_stage(256, 10)
    kern = MST.with_rerank_policy(MST.with_scan_policy(two, use_kernel=True),
                                  rerank_kernel=True)
    ids_k, sc_k, dt, nq = run_cascade(r, qb, kern, args.batch)
    counts = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    for name in ("pooling", "maxsim_scan", "maxsim_rerank"):
        check(counts[name] > 0, f"(d) kernel {name} was never launched")
    m_k = evaluate_ranking(ids_k, qrels, ks=(5, 10))
    DSP.reset_counts()
    plain = MST.with_scan_policy(two, use_kernel=False, chunk=256)
    ids_p, sc_p, _, _ = run_cascade(r, qb, plain, args.batch)
    check(all(DSP.launch_count(k) == 0 for k in DSP.KERNELS),
          "(d) the plain path launched a kernel")
    m_p = evaluate_ranking(ids_p, qrels, ks=(5, 10))
    swaps, cut_rows = compare_two_stage(
        r.store.vectors, r.store.segments[0].doc_ids,
        lambda q, qm, st: r.search(q, qm, stages=st, translate_ids=False),
        kern, qb.queries, qb.query_mask, ids_k, sc_k, ids_p, sc_p,
        "(d) encoded corpus, kernel vs plain")
    gaps = sc_p[:, 0] - sc_p[:, -1]
    for key in m_k:
        check(abs(m_k[key] - m_p[key]) < 5e-4, f"(d) {key}: kernel "
              f"{m_k[key]:.4f} != plain {m_p[key]:.4f} to 3 decimals")
    log(f"[train] (d) encoded {n_pages} pages in batches of {enc_b} at "
        f"{n_pages / t_enc:.1f} pages/s and {n_pages} queries of "
        f"{qv.shape[1]} tokens; Retriever.ingest (hygiene, pooling kernel, "
        f"bf16 store) of {n_pages} pages; 2-stage(256, 10) kernels QPS "
        f"{nq / dt:.1f}: " + "  ".join(f"{k}={v:.4f}" for k, v in m_k.items())
        + f"; kernel == plain top-10 ids ({swaps} tie swaps; {cut_rows} "
        f"queries with a tie at a cutoff, the 256th stage-0 or the 10th "
        f"final score, each the plain top-10 over its kernel candidates), "
        f"metrics equal to 3 "
        f"decimals; plain score of rank 1 - rank 10: median "
        f"{float(np.median(gaps)):.3e}, min {float(gaps.min()):.3e}; "
        f"launches {used(counts)}")
    res["d"] = dict(pages_s=n_pages / t_enc, metrics=m_k, qps=nq / dt)
    del r, fresh, fopt
    torch.cuda.empty_cache()
    return dict(res=res, counts=counts)


def query_set(queries, query_mask):
    """Queries in the shape ``run_cascade`` reads (``.queries``,
    ``.query_mask``)."""
    import types
    return types.SimpleNamespace(queries=queries, query_mask=query_mask)


# ---------------------------------------------------------------------------
# phase 4l: the decoder-LM family
# ---------------------------------------------------------------------------

def event_ms(fn) -> tuple:
    """(``fn()``, its milliseconds on the card by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def lm_step_flops(cfg, B: int, S: int) -> tuple:
    """(FLOPs of one LM train step, the formula): 6 N T for the forward
    and backward passes plus 2 N T for the forward that ``remat``
    recomputes, N = ``n_active_params``, T = B S tokens; the attention
    scores (4 B S^2 H hd L a forward) are left out and printed beside."""
    N, T_ = cfg.n_active_params(), B * S
    attn = 4 * B * S * S * cfg.n_heads * cfg.head_dim * cfg.n_layers
    formula = (f"8 N T = (6 + 2 remat) x N {N} x T {T_} (B {B} x S {S}); "
               f"attention scores 4 x 4 B S^2 H hd L = {4 * attn:.3e} more, "
               "left out")
    return 8.0 * N * T_, formula


def lm_card_vs_cpu(args, dev) -> dict:
    """(a) each LM arch at the launcher's ``reduced_lm`` size, float32:
    loss, logits and every gradient of one step on the card against the
    CPU, from the same seeded weights and batch."""
    import copy
    from repro_torch.configs import LM_ARCHS, get_config
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T

    out = {}
    for arch in LM_ARCHS:
        cfg = TR.reduced_lm(get_config(arch))
        cpu = T.init_params(cfg, torch.Generator().manual_seed(args.seed),
                            device="cpu")
        gpu = copy.deepcopy(cpu).to(dev)
        b = TR.make_batch(cfg, args.seed, 0, 4, 64, "cpu")
        bg = {k: v.to(dev) for k, v in b.items()}
        loss_c = T.loss_fn(cpu, b)
        loss_c.backward()
        loss_g = T.loss_fn(gpu, bg)
        loss_g.backward()
        with torch.no_grad():
            lg_c = T._logits(cpu, T.forward(cpu, b["tokens"]))
            lg_g = T._logits(gpu, T.forward(gpu, bg["tokens"])).cpu()
        lc, lg = loss_c.item(), loss_g.item()
        check(np.isfinite(lg) and abs(lg - lc) <= 1e-5 * abs(lc),
              f"(a) {arch}: card loss {lg!r} != CPU loss {lc!r} (rtol 1e-5)")
        try:
            torch.testing.assert_close(lg_g, lg_c, rtol=1e-5, atol=1e-5)
        except AssertionError as e:
            fail(f"(a) {arch}: card logits != CPU (rtol 1e-5, atol 1e-5): "
                 f"{e}")
        gc = dict(cpu.named_parameters())
        worst, n = 0.0, 0
        for name, p in gpu.named_parameters():
            got, want = p.grad.cpu(), gc[name].grad
            check(bool(torch.isfinite(got).all()),
                  f"(a) {arch}: grad {name} not finite")
            try:
                torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-6)
            except AssertionError as e:
                fail(f"(a) {arch}: grad {name}: card != CPU (rtol 1e-3, "
                     f"atol 1e-6): {e}")
            worst = max(worst, float((got - want).abs().max()))
            n += 1
        out[arch] = dict(loss_rel=abs(lg - lc) / abs(lc), grad_abs=worst,
                         logit_abs=float((lg_g - lg_c).abs().max()))
        log(f"[lm] (a) {arch} (reduced: {cfg.n_layers} layers, d "
            f"{cfg.d_model}, vocab {cfg.vocab_size}"
            + (f", {cfg.moe.n_experts} experts top {cfg.moe.top_k}"
               if cfg.moe else "") + f"), batch 4 x 64, f32: loss {lg:.7f} "
            f"vs CPU {lc:.7f} (rel err {out[arch]['loss_rel']:.2e}, rtol "
            f"1e-5); logits max abs err {out[arch]['logit_abs']:.2e} (rtol "
            f"1e-5, atol 1e-5); {n} grad tensors within rtol 1e-3, atol "
            f"1e-6, max abs err {worst:.2e}")
        del cpu, gpu
    return out


def lm_train_full(args, dev) -> dict:
    """(b) minicpm-2b at full width and depth, bf16, through the
    launcher's own build, batches and step at its defaults."""
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as OPT

    a = TR.parse_args(["--arch", "minicpm-2b", "--device", "cuda",
                       "--seed", str(args.seed)])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base0 = torch.cuda.memory_allocated()
    run = TR.build(a.arch, a.steps, a.reduced, a.seed, dev)
    cfg, model, opt, step_fn = (run["cfg"], run["model"], run["opt"],
                                run["step_fn"])
    n_params = sum(p.numel() for p in model.parameters())
    state_gb = (torch.cuda.memory_allocated() - base0) / 1e9
    n_warm, n_timed = 2, 5
    metrics, times = [], []
    for i in range(n_warm + n_timed):
        b = TR.make_batch(cfg, a.seed, i, a.batch, a.seq, dev)
        m, ms = event_ms(lambda: step_fn(model, opt, b))
        metrics.append(m)
        if i >= n_warm:
            times.append(ms)
    peak = torch.cuda.max_memory_allocated() - base0
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    lrs = torch.stack([m["lr"] for m in metrics]).cpu()
    want_lr = OPT.make_schedule(run["oc"])(torch.arange(
        1, len(metrics) + 1, dtype=torch.int32, device=dev)).cpu()
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"(b) non-finite loss or grad_norm: {losses} {gnorms}")
    check(bool(torch.equal(lrs, want_lr)), f"(b) lr sequence {lrs.tolist()}"
          f" != the {run['oc'].schedule} schedule {want_lr.tolist()}")
    ms = statistics.median(times)
    tokens = a.batch * a.seq
    flops, formula = lm_step_flops(cfg, a.batch, a.seq)
    tflops = flops / (ms / 1e3) / 1e12
    log(f"[lm] (b) {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
        f"padded to {T.padded_vocab(cfg)}, {n_params / 1e9:.4f}e9 params "
        f"(n_params {cfg.n_params() / 1e9:.4f}e9), dtype {cfg.dtype}, "
        f"params/grads/moments f32; the launcher's step at its defaults "
        f"(batch {a.batch}, seq {a.seq}, {run['oc'].schedule} over "
        f"{a.steps} steps, warmup {run['oc'].warmup}): {n_warm} warm-up + "
        f"{n_timed} timed steps; median {ms:.1f} ms/step (min "
        f"{min(times):.1f}, max {max(times):.1f}), "
        f"{tokens / (ms / 1e3):.1f} tokens/s; losses "
        + " ".join(f"{x:.4f}" for x in losses) + "; grad_norms "
        + " ".join(f"{x:.4f}" for x in gnorms) + f"; lr == schedule at "
        f"steps 1-{len(metrics)} ({float(lrs[-1]):.3e} at the last)")
    log(f"[lm] (b) {flops:.4e} FLOPs per step = {formula}; {tflops:.2f} "
        f"TFLOP/s, {100 * tflops / (BF16_TC_FLOPS_PER_S / 1e12):.2f}% of "
        f"the bf16 tensor-core rate ({BF16_TC_FLOPS_PER_S / 1e12:.0f} "
        f"TFLOP/s) (the step by phase: (f)); train state "
        f"(params + m + v) {state_gb:.2f} GB, peak device memory of the "
        f"phase {peak / 1e9:.2f} GB (max_memory_allocated above the "
        f"{base0 / 1e9:.2f} GB held before it)")
    return dict(ms=ms, tokens_s=tokens / (ms / 1e3), flops=flops,
                tflops=tflops, peak_gb=peak / 1e9, state_gb=state_gb)


def cache_bytes(caches) -> int:
    return sum(t.numel() * t.element_size() for seg in caches for slot in seg
               for t in slot.values())


def lm_decode_full(args, dev) -> dict:
    """(c) gemma3-4b at full width and depth: prefill past the 1024-token
    window, then greedy decode; f32 against full forwards, then bf16
    timed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.dispatch import full_f32
    from repro_torch.models import kv_cache as KV
    from repro_torch.models import transformer as T

    cfg = get_config("gemma3-4b")
    B, S, n_dec = 2, 1536, 16
    torch.cuda.empty_cache()
    base0 = torch.cuda.memory_allocated()
    model = T.init_params(dataclasses.replace(cfg, dtype="float32"),
                          torch.Generator(device=dev).manual_seed(args.seed),
                          dev)
    n_params = sum(p.numel() for p in model.parameters())
    param_gb = (torch.cuda.memory_allocated() - base0) / 1e9
    plan = T.segment_plan(cfg)
    sc = {w: KV.cache_len(w, S + n_dec) for _, ws in plan for w in ws}
    rng = np.random.default_rng(args.seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                            .astype(np.int32)).to(dev)

    def generate():
        """Prefill, then n_dec greedy steps: (tokens, each step's logits,
        caches, ms per decode step by CUDA events)."""
        logits, caches = T.prefill_step(model, {"tokens": toks},
                                        decode_budget=n_dec)
        seq, steps = toks, []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n_dec):
            nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            seq = torch.cat([seq, nxt], 1)
            logits, caches = T.decode_step(model, caches, nxt, S + i)
            steps.append(logits)
        end.record()
        end.synchronize()
        return seq, steps, caches, start.elapsed_time(end) / n_dec

    # f32 (TF32 off): decode against the full forward over the prefix
    full_f32()
    generate()                                    # warm-up
    seq, steps, caches, ms_tok32 = generate()
    errs = {}
    with torch.no_grad():
        for i in (0, n_dec - 1):
            ref = T._logits(model, T.forward(model, seq[:, :S + 1 + i])
                            [:, -1:])
            got = steps[i]
            ok = bool(torch.allclose(got, ref, rtol=2e-3, atol=2e-3))
            errs[i] = (float((got - ref).abs().max()),
                       float(ref.abs().max()))
            check(bool(torch.isfinite(got).all()) and ok,
                  f"(c) f32 decode step {i + 1} (position {S + i}) logits "
                  f"!= the full forward over its prefix (rtol 2e-3, atol "
                  f"2e-3; max abs err {errs[i][0]:.3e})")
    f32_tokens = seq[:, S:].cpu()
    f32_cache = cache_bytes(caches)
    del caches, steps
    torch.cuda.empty_cache()
    _, ms_pf32 = event_ms(lambda: T.prefill_step(
        model, {"tokens": toks}, decode_budget=n_dec))

    # bf16, the config's dtype: timed after one warm-up generation
    model.cfg = cfg
    torch.cuda.empty_cache()
    generate()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, ms_pf = event_ms(lambda: T.prefill_step(
        model, {"tokens": toks}, decode_budget=n_dec))
    seq, steps, caches, ms_tok = generate()
    logits = steps[-1]
    peak = torch.cuda.max_memory_allocated() - base0
    check(bool(torch.isfinite(logits.float()).all()),
          "(c) bf16 decode logits not finite")
    bf16_cache = cache_bytes(caches)
    same = float((seq[:, S:].cpu() == f32_tokens).float().mean())
    log(f"[lm] (c) {cfg.name}: {cfg.n_layers} layers ({sum(r * len(w) for r, w in plan)} "
        f"= plan {plan}), d {cfg.d_model}, head_dim {cfg.head_dim}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, vocab "
        f"{cfg.vocab_size}; {n_params / 1e9:.4f}e9 params (n_params "
        f"{cfg.n_params() / 1e9:.4f}e9), {param_gb:.2f} GB f32; B {B}, "
        f"prefill S {S} with decode_budget {n_dec}: cache slots {sc} "
        f"(the 1024 ring rolled by {S % sc[1024]}, wraps during decode)")
    log(f"[lm] (c) f32 (TF32 off): {n_dec} greedy decode steps; step 1 "
        f"logits vs the full forward over {S + 1} tokens max abs err "
        f"{errs[0][0]:.3e} (max |logit| {errs[0][1]:.2f}), step {n_dec} vs "
        f"{S + n_dec} tokens {errs[n_dec - 1][0]:.3e} (max |logit| "
        f"{errs[n_dec - 1][1]:.2f}); rtol 2e-3, atol 2e-3; prefill "
        f"{ms_pf32:.1f} ms, decode {ms_tok32:.2f} ms per step of {B} tokens;"
        f" cache {f32_cache / 1e6:.1f} MB")
    log(f"[lm] (c) bf16: prefill {ms_pf:.1f} ms ({B * S / (ms_pf / 1e3):.0f} "
        f"tokens/s), decode {ms_tok:.2f} ms per step of {B} tokens "
        f"({B / (ms_tok / 1e3):.1f} tokens/s); cache {bf16_cache / 1e6:.1f} "
        f"MB; peak device memory {peak / 1e9:.2f} GB above the "
        f"{base0 / 1e9:.2f} GB held before the phase; greedy tokens equal "
        f"to the f32 run's: {100 * same:.1f}%")
    return dict(decode_ms_f32=ms_tok32, err_first=errs[0][0], err_last=errs[n_dec - 1][0],
                prefill_ms_f32=ms_pf32, prefill_ms=ms_pf, decode_ms=ms_tok,
                cache_mb=bf16_cache / 1e6, peak_gb=peak / 1e9)


def lm_moe_full(args, dev) -> dict:
    """(d) granite-moe-1b-a400m at full width and depth, f32: the dense
    and the ragged MoE on one batch (losses, router ids), then one train
    step under each."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as TR
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train_loop import make_train_step

    base = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                               dtype="float32")
    cfgs = {impl: dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, impl=impl)) for impl in ("dense", "ragged")}
    B, S, tie = 4, 256, 1e-4
    torch.cuda.empty_cache()
    model = T.init_params(cfgs["dense"],
                          torch.Generator(device=dev).manual_seed(args.seed),
                          dev)
    b = TR.make_batch(base, args.seed, 0, B, S, dev)
    k = base.moe.top_k
    routed = {}
    router = L.moe_router

    def recording(p, x2d, top_k_):
        out = router(p, x2d, top_k_)
        vals, _ = L.top_k(x2d @ p["router"].to(x2d.dtype), top_k_ + 1)
        routed[impl].append((out[1], vals))
        return out
    losses = {}
    L.moe_router = recording
    try:
        with torch.no_grad():
            for impl, cfg in cfgs.items():
                routed[impl] = []
                model.cfg = cfg
                losses[impl] = float(T.loss_fn(model, b))
    finally:
        L.moe_router = router
    rel = abs(losses["ragged"] - losses["dense"]) / abs(losses["dense"])
    check(np.isfinite(losses["dense"]) and rel <= 1e-3,
          f"(d) ragged loss {losses['ragged']!r} != dense {losses['dense']!r}"
          " (rtol 1e-3)")
    check(len(routed["dense"]) == len(routed["ragged"]) == base.n_layers,
          "(d) the router ran a different number of times")
    flips = 0
    for layer, ((ids_d, vals_d), (ids_r, _)) in enumerate(
            zip(routed["dense"], routed["ragged"])):
        ids_d, ids_r = ids_d.cpu().numpy(), ids_r.cpu().numpy()
        vals_d = vals_d.float().cpu().numpy()
        for t in np.flatnonzero((ids_d != ids_r).any(1)):
            n, j = row_swaps(ids_r[t], ids_d[t], vals_d[t], tie)
            check(j is None, f"(d) layer {layer} token {t}: ragged router "
                  f"ids {ids_r[t].tolist()} != dense {ids_d[t].tolist()} "
                  f"at rank {j} without a tie within {tie}")
            flips += n
    n_ids = base.n_layers * B * S * k
    # one train step under each implementation
    params = dict(model.named_parameters())
    labels = OPT.default_labels(params)
    oc = OPT.OptConfig(lr=3e-4, warmup=10, total_steps=50)
    opt = OPT.init_opt_state(params, labels)
    step_fn = make_train_step(T.loss_fn, oc, labels=labels)
    times = {}
    for impl, cfg in cfgs.items():
        model.cfg = cfg
        step_fn(model, opt, b)                            # warm-up
        m, times[impl] = event_ms(lambda: step_fn(model, opt, b))
        check(np.isfinite(float(m["loss"])),
              f"(d) {impl} train step: non-finite loss")
    n_active = base.n_active_params()
    expert = 6 * B * S * base.n_layers * 3 * base.d_model * base.moe.d_ff
    log(f"[lm] (d) {base.name}: {base.n_layers} layers, d {base.d_model}, "
        f"{base.moe.n_experts} experts top {k}, expert d_ff "
        f"{base.moe.d_ff}, {sum(p.numel() for p in params.values()) / 1e9:.4f}"
        f"e9 params ({n_active / 1e9:.4f}e9 active), f32 (TF32 off), batch "
        f"{B} x {S}: loss dense {losses['dense']:.7f}, ragged "
        f"{losses['ragged']:.7f} (rel err {rel:.2e}, rtol 1e-3); router "
        f"ids of all {base.n_layers} layers equal in both runs "
        f"({n_ids} ids; {flips} swapped at a tie within {tie} of the "
        f"dense run's logits)")
    log(f"[lm] (d) one train step (fwd + bwd with remat + AdamW): dense "
        f"{times['dense']:.1f} ms, ragged {times['ragged']:.1f} ms "
        f"(dense / ragged {times['dense'] / times['ragged']:.2f}); expert "
        f"FLOPs a step (fwd + bwd + remat) ragged {expert * k * 8 / 6:.3e}, "
        f"dense {expert * base.moe.n_experts * 8 / 6:.3e} "
        f"(E/k = {base.moe.n_experts // k}x)")
    return dict(loss_rel=rel, flips=flips, dense_ms=times["dense"],
                ragged_ms=times["ragged"])


def lm_resume(args, dev) -> dict:
    """(e) the launcher at ``--reduced`` with ``--ckpt-dir``: 21 steps
    whose one checkpoint falls after step 10 (``--ckpt-every 11``), then
    the same command again, which must resume from step 10 and repeat
    the uninterrupted run's losses."""
    import contextlib
    import io
    import shutil
    import tempfile
    from repro_torch.launch import train as TR

    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="lm_ckpt_", dir=root)
    argv = ["--arch", "minicpm-2b", "--reduced", "--steps", "21",
            "--ckpt-every", "11", "--ckpt-dir", ckpt, "--seed",
            str(args.seed), "--device", "cuda"]
    try:
        outs, logs = [], []
        for _ in range(2):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                logs.append(TR.main(argv))
            outs.append(buf.getvalue())
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    whole, resumed = logs
    check("[resume] from step 10" in outs[1], "(e) the relaunch did not "
          f"print '[resume] from step 10': {outs[1][:200]!r}")
    check([r["step"] for r in resumed] == list(range(11, 21)),
          f"(e) the relaunch ran steps {[r['step'] for r in resumed]}")
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
           for a, b in zip(resumed, whole[11:])]
    check(max(rel) <= 1e-5, f"(e) resumed losses != the uninterrupted "
          f"run's (rtol 1e-5): {max(rel):.2e}")
    log(f"[lm] (e) launcher {' '.join(argv[:5])} --ckpt-every 11: the "
        f"relaunch printed '[resume] from step 10' and ran steps 11-20; "
        f"losses " + " ".join(f"{r['loss']:.6f}" for r in resumed)
        + f" (max rel err {max(rel):.2e} against the uninterrupted run, "
        "rtol 1e-5)")
    return dict(rel=max(rel))


def lm_step_phases(run, b, timer, loss_fn=None) -> dict:
    """One step of the launcher's train step (``make_train_step``'s body:
    forward, backward, optimizer update) with the card synchronised after
    each phase, each phase timed by ``timer`` (``event_ms``: wall
    milliseconds; ``profile_device_time``: device time by kind). Autograd
    runs the backward on its own thread, so ``record_function`` ranges
    around the phases of one unsynchronised step would not own its
    kernels. ``loss_fn(model, batch)`` defaults to the LM's."""
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as OPT

    model, opt, oc = run["model"], run["opt"], run["oc"]
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    loss, fwd = timer(lambda: (loss_fn or T.loss_fn)(model, b))
    _, bwd = timer(loss.backward)
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    _, upd = timer(lambda: OPT.apply_updates(
        params, grads, opt, oc, labels=run["labels"],
        schedule=OPT.make_schedule(oc)))
    for p in params.values():
        p.grad = None
    return {"forward": fwd, "backward": bwd, "update": upd}


def phases_line(wall: dict, device: dict) -> str:
    return "; ".join(
        f"{name} {wall[name]:.1f} ms wall, device {sum(v.values()):.1f} ms "
        f"(gemm {v['gemm']:.1f}, softmax {v['softmax']:.1f}, other "
        f"{v['other']:.1f})" for name, v in device.items())


def lm_profiles(args, dev, res) -> dict:
    """4l (f), after 4k: one train step of (b), one bf16 decode step of
    (c) and one train step under each MoE implementation of (d) under
    ``torch.profiler`` (device time by kind against the step times 4l
    measured unprofiled); (b)'s step split by phase, at the launcher's
    defaults and at the family's training seq 4096, timed there too. The
    profiles come after every timed part of 4l: a profiled step can leave
    later host-bound timings slower."""
    from repro_torch.configs import LM_SHAPES, get_config
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train_loop import make_train_step

    out = {}

    def part_b():
        a = TR.parse_args(["--arch", "minicpm-2b", "--seed", str(args.seed)])
        run = TR.build(a.arch, a.steps, a.reduced, a.seed, dev)
        cfg, model, opt = run["cfg"], run["model"], run["opt"]
        step_fn = run["step_fn"]
        b = TR.make_batch(cfg, a.seed, 0, a.batch, a.seq, dev)
        step_fn(model, opt, b)                            # warm-up
        wall = lm_step_phases(run, b, event_ms)
        # the family's training shape: LM_SHAPES train_4k's seq, the
        # largest batch of (4, 3, 2, 1) that fits beside the train state
        seq = next(s.dims["seq_len"] for s in LM_SHAPES
                   if s.name == "train_4k")
        torch.cuda.reset_peak_memory_stats()
        for B in (4, 3, 2, 1):
            b4k = TR.make_batch(cfg, a.seed, 1, B, seq, dev)
            try:
                step_fn(model, opt, b4k)                  # warm-up
                break
            except torch.cuda.OutOfMemoryError:
                log(f"[lm] (f) (b) seq {seq}: batch {B} does not fit")
            # outside the handler, whose traceback holds the step's tensors
            for p in model.parameters():
                p.grad = None
            b4k = None
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        check(b4k is not None, f"(f) no batch fits at seq {seq}")
        times = [event_ms(lambda: step_fn(model, opt, b4k))[1]
                 for _ in range(2)]
        peak = torch.cuda.max_memory_allocated()
        wall_4k = lm_step_phases(run, b4k, event_ms)
        # profiles last: a profiled step can leave later wall times slower
        _, out["b"] = profile_device_time(lambda: step_fn(model, opt, b))
        log("[lm] (f) (b) minicpm-2b: one train step under torch.profiler: "
            + busy_line(out["b"], res["b"]["ms"])
            + " (of (b)'s median unprofiled step)")
        out["b_phases"] = lm_step_phases(run, b, profile_device_time)
        log(f"[lm] (f) (b) at the launcher's defaults (batch {a.batch}, seq "
            f"{a.seq}), by phase: " + phases_line(wall, out["b_phases"]))
        torch.cuda.empty_cache()
        out["b_4k_phases"] = lm_step_phases(run, b4k, profile_device_time)
        ms = statistics.median(times)
        flops, formula = lm_step_flops(cfg, B, seq)
        tflops = flops / (ms / 1e3) / 1e12
        busy = sum(sum(v.values()) for v in out["b_4k_phases"].values())
        out["b_4k"] = dict(batch=B, seq=seq, ms=ms, tflops=tflops,
                           peak_gb=peak / 1e9)
        log(f"[lm] (f) (b) minicpm-2b at seq {seq} (LM_SHAPES train_4k), "
            f"batch {B}, the largest of (4, 3, 2, 1) that fits: 2 steps "
            f"after a warm-up, {' '.join(f'{t:.1f}' for t in times)} ms, "
            f"{B * seq / (ms / 1e3):.1f} tokens/s, {flops:.4e} FLOPs = "
            f"{formula}; {tflops:.2f} TFLOP/s; peak device memory "
            f"{peak / 1e9:.2f} GB; by phase (device {busy:.1f} ms in all, "
            f"{100 * busy / ms:.1f}% of the median step): "
            + phases_line(wall_4k, out["b_4k_phases"]))

    def part_c():
        cfg = get_config("gemma3-4b")
        B, S = 2, 1536
        model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
            args.seed), dev)
        toks = torch.from_numpy(np.random.default_rng(args.seed).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
        logits, caches = T.prefill_step(model, {"tokens": toks},
                                        decode_budget=2)
        nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        logits, caches = T.decode_step(model, caches, nxt, S)  # warm-up
        nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        _, out["c"] = profile_device_time(
            lambda: T.decode_step(model, caches, nxt, S + 1))
        log("[lm] (f) (c) gemma3-4b bf16: one decode step under "
            "torch.profiler: " + busy_line(out["c"], res["c"]["decode_ms"])
            + " (of (c)'s mean unprofiled step)")

    def part_d():
        base = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                                   dtype="float32")
        model = T.init_params(base, torch.Generator(device=dev).manual_seed(
            args.seed), dev)
        params = dict(model.named_parameters())
        labels = OPT.default_labels(params)
        opt = OPT.init_opt_state(params, labels)
        step_fn = make_train_step(T.loss_fn, OPT.OptConfig(
            lr=3e-4, warmup=10, total_steps=50), labels=labels)
        b = TR.make_batch(base, args.seed, 0, 4, 256, dev)
        for impl in ("dense", "ragged"):
            model.cfg = dataclasses.replace(base, moe=dataclasses.replace(
                base.moe, impl=impl))
            step_fn(model, opt, b)                        # warm-up
            _, out[f"d_{impl}"] = profile_device_time(
                lambda: step_fn(model, opt, b))
            log(f"[lm] (f) (d) granite-moe {impl}: one train step under "
                "torch.profiler: " + busy_line(out[f"d_{impl}"],
                                               res["d"][f"{impl}_ms"])
                + " (of (d)'s unprofiled step)")

    for part in (part_b, part_c, part_d):
        torch.cuda.empty_cache()
        part()
    torch.cuda.empty_cache()
    return out


def lm_path(args, dev) -> dict:
    """Phase 4l: the decoder-LM family on the card, (a)-(e); its
    profiles (f) run later (``lm_profiles``)."""
    torch.cuda.empty_cache()
    log(f"[lm] device memory held by earlier phases: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    t0 = time.perf_counter()
    res = {}
    for part, fn in (("a", lm_card_vs_cpu), ("b", lm_train_full),
                     ("c", lm_decode_full), ("d", lm_moe_full),
                     ("e", lm_resume)):
        res[part] = fn(args, dev)
        torch.cuda.empty_cache()           # the part's model is gone
    log(f"[lm] phase 4l took {time.perf_counter() - t0:.1f}s")
    return res


# ---------------------------------------------------------------------------
# phase 4m: the recsys family
# ---------------------------------------------------------------------------

RECSYS_ROW_CAP = 4_194_304    # dlrm-mlperf's rows per field on one card
# the cells' shapes (configs RECSYS_SHAPES; cells.py's bert4rec MLM batch)
RECSYS_SIZES = dict(p99=512, p99_calls=200, bulk=262144, chunk=32768,
                    n_cand=1_000_000, parity_n=65536, train=65536,
                    mlm=40, negs=256, slate=64)


def recsys_config(arch: str):
    """The arch's full config; dlrm-mlperf with each of its 26 Criteo-1TB
    fields capped at ``RECSYS_ROW_CAP`` rows (its full 96.1 GB table waits
    for four cards), every width unchanged."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch == "dlrm-mlperf":
        cfg = dataclasses.replace(cfg, vocab_sizes=tuple(
            min(v, RECSYS_ROW_CAP) for v in cfg.vocab_sizes))
    return cfg


def recsys_reduced(arch: str):
    """The CPU tests' sizes (``tests/test_archs.py``'s ``reduced_recsys``:
    every field 50 rows; bert4rec 300 items, seq 12, d 16)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch == "bert4rec":
        return dataclasses.replace(cfg, n_items=300, seq_len=12,
                                   embed_dim=16)
    over = dict(vocab_sizes=tuple([50] * len(cfg.vocab_sizes)))
    if arch == "dcn-v2":
        over["mlp"] = (64, 32)
    if arch == "dlrm-mlperf":
        over.update(bot_mlp=(32, 16, 8), top_mlp=(64, 32, 1), embed_dim=8)
    return dataclasses.replace(cfg, **over)


def recsys_dense_flops(cfg, batch: int) -> tuple:
    """(FLOPs of one forward over ``batch`` rows, the formula):
    ``launch/cells.py``'s ``_recsys_dense_flops``, 2 x the multiply-adds
    of the dense products (table lookups and elementwise work left
    out)."""
    from repro_torch.launch.cells import _recsys_dense_flops
    if cfg.name == "dcn-v2":
        d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
        formula = f"3 cross 2 d0^2 + MLP {(d0,) + tuple(cfg.mlp)}, d0 {d0}"
    elif cfg.name == "autoint":
        formula = (f"per layer 8 F din H da + 4 F^2 H da, F {cfg.n_sparse}, "
                   f"H {cfg.n_heads}, da {cfg.d_attn}")
    elif cfg.name == "dlrm-mlperf":
        n_vec = cfg.n_sparse + 1
        n_int = n_vec * (n_vec - 1) // 2
        formula = (f"bottom MLP + 2 27^2 d + top MLP "
                   f"{(n_int + cfg.embed_dim,) + tuple(cfg.top_mlp)}")
    else:
        formula = (f"blocks x (8 S d^2 + 4 S^2 d + 16 S d^2), S "
                   f"{cfg.seq_len}, d {cfg.embed_dim}")
    f = _recsys_dense_flops(cfg, 1)
    return _recsys_dense_flops(cfg, batch), f"{formula}, {f:.4e} a row"


def recsys_batch(cfg, B: int, dev, gen, kind: str) -> dict:
    """A synthetic batch on ``dev`` from ``gen``. CTR: ids uniform in each
    field's vocabulary, 13 dense features normal, labels 0/1 (``train``).
    bert4rec: item ids, a valid prefix of 1-S items per row, and for
    ``train`` ``RECSYS_SIZES["mlm"]`` MLM positions inside it with their
    labels and ``negs`` shared negatives; ``serve`` adds a slate of
    ``slate`` items a row. ``query`` is one row without labels."""
    def ints(hi, shape):
        return torch.randint(0, 2 ** 62, shape, generator=gen,
                             device=dev) % hi
    if cfg.name == "bert4rec":
        S, M = cfg.seq_len, RECSYS_SIZES["mlm"]
        lens = ints(S, (B,)) + 1
        b = {"seq": ints(cfg.n_items, (B, S)),
             "seq_mask": torch.arange(S, device=dev)[None] < lens[:, None]}
        if kind == "train":
            b.update(mlm_positions=(torch.rand(
                (B, M), generator=gen, device=dev) * lens[:, None]).long(),
                mlm_labels=ints(cfg.n_items, (B, M)),
                mlm_mask=torch.ones((B, M), dtype=torch.bool, device=dev),
                neg_samples=ints(cfg.n_items, (RECSYS_SIZES["negs"],)))
        if kind == "serve":
            b["slate"] = ints(cfg.n_items, (B, RECSYS_SIZES["slate"]))
        return b
    vocab = torch.tensor(cfg.vocab_sizes, device=dev)
    b = {"sparse": ints(vocab, (B, cfg.n_sparse))}
    if cfg.n_dense:
        b["dense"] = torch.randn((B, cfg.n_dense), generator=gen, device=dev)
    if kind == "train":
        b["labels"] = ints(2, (B,)).float()
    return b


def recsys_card_vs_cpu(args, dev) -> dict:
    """(a) each arch at the CPU tests' sizes from one seeded model on the
    host, copied to the card: loss, every gradient, ``serve_step``, 1- and
    2-stage ``retrieval_step`` over 300 candidates and 5 train steps on
    the card against the CPU."""
    import copy
    from repro_torch.configs import RECSYS_ARCHS
    from repro_torch.models.recsys import nets as R
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train_loop import make_train_step

    out = {}
    for arch in RECSYS_ARCHS:
        cfg = recsys_reduced(arch)
        cpu = R.init_params(cfg, torch.Generator().manual_seed(args.seed),
                            device="cpu")
        gpu = copy.deepcopy(cpu).to(dev)
        gen = torch.Generator().manual_seed(args.seed + 1)
        B = 4 if arch == "bert4rec" else 16
        b = recsys_batch(cfg, B, "cpu", gen, "train")
        to = lambda x: {k: v.to(dev) for k, v in x.items()}  # noqa: E731
        loss_c = R.loss_fn(cfg, cpu, b)
        loss_c.backward()
        loss_g = R.loss_fn(cfg, gpu, to(b))
        loss_g.backward()
        lc, lg = loss_c.item(), loss_g.item()
        check(np.isfinite(lg) and abs(lg - lc) <= 1e-5 * abs(lc),
              f"(a) {arch}: card loss {lg!r} != CPU loss {lc!r} (rtol 1e-5)")
        gcpu = dict(cpu.named_parameters())
        g_err = 0.0
        for name, p in gpu.named_parameters():
            got, want = p.grad.cpu(), gcpu[name].grad
            try:
                torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-6)
            except AssertionError as e:
                fail(f"(a) {arch}: grad {name}: card != CPU (rtol 1e-3, "
                     f"atol 1e-6): {e}")
            g_err = max(g_err, float((got - want).abs().max()))
        sb = recsys_batch(cfg, B, "cpu", gen, "serve")
        s_c = R.serve_step(cfg, cpu, sb)
        s_g = R.serve_step(cfg, gpu, to(sb)).cpu()
        try:
            torch.testing.assert_close(s_g, s_c, rtol=1e-5, atol=1e-6)
        except AssertionError as e:
            fail(f"(a) {arch}: serve_step card != CPU (rtol 1e-5, atol "
                 f"1e-6): {e}")
        rb = recsys_batch(cfg, 1, "cpu", gen, "query")
        rb["candidates"] = torch.arange(300)
        r_err, swaps = 0.0, 0
        for stages in (1, 2):
            kw = dict(stages=stages, prefetch_k=64)
            sg, ig = R.retrieval_step(cfg, gpu, to(rb), top_k=20, **kw)
            sc, ic = R.retrieval_step(cfg, cpu, rb, top_k=21, **kw)
            sg, ig = sg.cpu(), ig.cpu()
            swaps += compare_rankings(
                ig[None].numpy(), sg[None].numpy(), ic[None].numpy(),
                sc[None].numpy(), f"(a) {arch} {stages}-stage", tie=1e-5)
            try:
                torch.testing.assert_close(sg, sc[:20], rtol=1e-5, atol=1e-6)
            except AssertionError as e:
                fail(f"(a) {arch} {stages}-stage scores card != CPU (rtol "
                     f"1e-5, atol 1e-6): {e}")
            r_err = max(r_err, float((sg - sc[:20]).abs().max()))
        losses = {}
        for side, model, d in (("cpu", copy.deepcopy(cpu), "cpu"),
                               ("card", copy.deepcopy(cpu).to(dev), dev)):
            params = dict(model.named_parameters())
            labels = OPT.default_labels(params)
            opt = OPT.init_opt_state(params, labels)
            step = make_train_step(lambda m, x: R.loss_fn(cfg, m, x),
                                   OPT.OptConfig(lr=1e-2, warmup=1,
                                                 total_steps=20),
                                   labels=labels)
            bb = {k: v.to(d) for k, v in b.items()}
            losses[side] = [float(step(model, opt, bb)["loss"])
                            for _ in range(5)]
        lcpu, lcard = np.array(losses["cpu"]), np.array(losses["card"])
        check(np.allclose(lcard, lcpu, rtol=1e-4, atol=0) and
              lcard[-1] < lcard[0], f"(a) {arch}: 5 train steps card "
              f"{lcard.tolist()} vs CPU {lcpu.tolist()} (rtol 1e-4, the "
              "last below the first)")
        out[arch] = dict(loss_rel=abs(lg - lc) / abs(lc), grad_abs=g_err,
                         serve_abs=float((s_g - s_c).abs().max()),
                         ret_abs=r_err, swaps=swaps,
                         train_rel=float(np.max(np.abs(lcard - lcpu)
                                                / np.abs(lcpu))))
        o = out[arch]
        log(f"[recsys] (a) {arch} (CPU tests' size), card vs CPU: loss "
            f"{lg:.7f} vs {lc:.7f} (rel err {o['loss_rel']:.2e}, rtol "
            f"1e-5); grads max abs err {g_err:.2e} (rtol 1e-3, atol 1e-6); "
            f"serve_step {o['serve_abs']:.2e} (rtol 1e-5, atol 1e-6); 1- and "
            f"2-stage retrieval over 300 candidates: ids equal ({swaps} "
            f"swaps at ties within 1e-5), scores {r_err:.2e} (rtol 1e-5, "
            f"atol 1e-6); 5 train steps, losses "
            + " ".join(f"{x:.5f}" for x in lcard)
            + f" (rel err {o['train_rel']:.2e}, rtol 1e-4)")
    return out


def recsys_serve(cfg, model, dev, gen) -> dict:
    """(b) serve_p99 and (c) serve_bulk through ``serve_step``."""
    from repro_torch.models.recsys import nets as R
    z = RECSYS_SIZES
    b = recsys_batch(cfg, z["p99"], dev, gen, "serve")
    for _ in range(3):
        out = R.serve_step(cfg, model, b)
    torch.cuda.synchronize()
    times = []
    for _ in range(z["p99_calls"]):
        t0 = time.perf_counter()
        out = R.serve_step(cfg, model, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(out).all()), f"(b) {cfg.name}: non-finite "
          "serve output")
    p50, p99 = np.percentile(times, [50, 99])
    res = dict(p50=p50, p99=p99, rows_s=z["p99"] / (p50 / 1e3))
    del b, out
    b = recsys_batch(cfg, z["bulk"], dev, gen, "serve")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = R.serve_step(cfg, model, b, chunk=z["chunk"])      # warm-up
    bulk = [event_ms(lambda: R.serve_step(cfg, model, b,
                                          chunk=z["chunk"]))[1]
            for _ in range(3)]
    peak = torch.cuda.max_memory_allocated() - base
    first = R.serve_step(cfg, model, {k: v[:z["chunk"]] for k, v in
                                      b.items()}, chunk=z["chunk"])
    check(bool(torch.equal(out[:z["chunk"]], first)),
          f"(c) {cfg.name}: the first chunk of the bulk call != a direct "
          f"call on its {z['chunk']} rows")
    check(bool(torch.isfinite(out).all()), f"(c) {cfg.name}: non-finite "
          "bulk output")
    ms = statistics.median(bulk)
    res.update(bulk_ms=ms, bulk_rows_s=z["bulk"] / (ms / 1e3),
               bulk_peak_gb=peak / 1e9)
    log(f"[recsys] (b) {cfg.name} serve_p99: batch {z['p99']}, "
        f"{z['p99_calls']} synchronised calls: p50 {p50:.3f} ms, p99 "
        f"{p99:.3f} ms, {res['rows_s']:.1f} rows/s at p50; (c) serve_bulk: "
        f"{z['bulk']} rows in {z['bulk'] // z['chunk']} chunks of "
        f"{z['chunk']}: {ms:.1f} ms (3 calls: "
        + " ".join(f"{t:.1f}" for t in bulk) + f"), "
        f"{res['bulk_rows_s']:.1f} rows/s, peak {peak / 1e9:.2f} GB above "
        "the model; first chunk bit for bit a direct call")
    return res


def recsys_retrieval(cfg, model, dev, gen) -> dict:
    """(d) retrieval_cand: one query against ``n_cand`` candidates, exact
    1-stage and 2-stage(256 -> 100, d_proxy 16), with and without a
    ``cand_proxy`` table; then 2-stage with prefetch = N against 1-stage
    at ``parity_n``."""
    from repro_torch.models.recsys import nets as R
    N = RECSYS_SIZES["n_cand"]
    q = recsys_batch(cfg, 1, dev, gen, "query")
    cand = torch.arange(N, device=dev)
    proxy = torch.randn((N, 16), generator=gen, device=dev)
    runs = {"1-stage": (dict(stages=1), {}),
            "2-stage": (dict(stages=2), {}),
            "2-stage cand_proxy": (dict(stages=2), {"cand_proxy": proxy})}
    res = {}
    for name, (kw, extra) in runs.items():
        batch = dict(q, candidates=cand, **extra)
        R.retrieval_step(cfg, model, batch, **kw)           # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, i = R.retrieval_step(cfg, model, batch, **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(s).all()) and i.shape == (100,),
              f"(d) {cfg.name} {name}: non-finite scores or shape "
              f"{tuple(i.shape)}")
        ms = statistics.median(times)
        res[name] = dict(ms=ms, qps=1e3 / ms, ids=i, scores=s)
    exact = set(res["1-stage"]["ids"].tolist())
    for name in ("2-stage", "2-stage cand_proxy"):
        r = res[name]
        r["recall"] = len(exact & set(r["ids"].tolist())) / 100
        # every final score is the full model's score of that candidate
        s_re, _ = R.retrieval_step(cfg, model, dict(
            q, candidates=cand[r["ids"]]), stages=1, top_k=100)
        try:
            torch.testing.assert_close(r["scores"], s_re, rtol=1e-5,
                                       atol=1e-6)
        except AssertionError as e:
            fail(f"(d) {cfg.name} {name}: final scores != the full model's "
                 f"(rtol 1e-5, atol 1e-6): {e}")
    n = RECSYS_SIZES["parity_n"]
    small = dict(q, candidates=cand[:n])
    _, i1 = R.retrieval_step(cfg, model, small, stages=1)
    _, i2 = R.retrieval_step(cfg, model, small, stages=2, prefetch_k=n)
    check(bool(torch.equal(i1, i2)), f"(d) {cfg.name}: at N={n} the 2-stage "
          "ids with prefetch_k = N != the 1-stage ids")
    one = res["1-stage"]
    item = R._item_field(cfg) if cfg.name != "bert4rec" else "items"
    log(f"[recsys] (d) {cfg.name} retrieval_cand, N {N} (item field "
        f"{item}): "
        + "; ".join(f"{k} {v['ms']:.2f} ms/query, {v['qps']:.1f} QPS"
                    + (f", recall@100 {v['recall']:.2f}" if "recall" in v
                       else "") for k, v in res.items())
        + f"; 2-stage/1-stage QPS {res['2-stage']['qps'] / one['qps']:.2f}"
        f" ({res['2-stage cand_proxy']['qps'] / one['qps']:.2f} with "
        f"cand_proxy); final scores == the full model's (rtol 1e-5, atol "
        f"1e-6); at N "
        f"{n} 2-stage with prefetch N == 1-stage ids")
    return {k: {kk: vv for kk, vv in v.items() if kk not in ("ids",
                                                             "scores")}
            for k, v in res.items()}


def recsys_train_setup(cfg, model, dev):
    """(oc, labels, opt, step_fn, run) of ``cells.py``'s recsys train cell
    (``OptConfig(lr=1e-3)``, row-wise Adagrad on the tables)."""
    from repro_torch.models.recsys import nets as R
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train_loop import make_train_step
    oc = OPT.OptConfig(lr=1e-3)
    params = dict(model.named_parameters())
    labels = OPT.default_labels(params)
    opt = OPT.init_opt_state(params, labels)
    loss = lambda m, b: R.loss_fn(cfg, m, b)                 # noqa: E731
    step_fn = make_train_step(loss, oc, labels=labels)
    return step_fn, dict(model=model, opt=opt, oc=oc, labels=labels,
                         loss_fn=loss)


def recsys_train_batch(cfg, model, dev, gen, step_fn, run) -> tuple:
    """(batch, B): ``train`` rows; bert4rec the largest of train, /2, /4,
    /8 whose warm-up step fits beside the model."""
    B = RECSYS_SIZES["train"]
    sizes = (B, B // 2, B // 4, B // 8) if cfg.name == "bert4rec" else (B,)
    for B in sizes:
        b = recsys_batch(cfg, B, dev, gen, "train")
        try:
            step_fn(model, run["opt"], b)                    # warm-up
            return b, B
        except torch.cuda.OutOfMemoryError:
            log(f"[recsys] (e) {cfg.name}: batch {B} does not fit")
        # outside the handler, whose traceback holds the step's tensors
        for p in model.parameters():
            p.grad = None
        b = None
        gc.collect()
        torch.cuda.empty_cache()
    fail(f"(e) {cfg.name}: no batch of {sizes} fits")


def recsys_train(cfg, model, dev, gen) -> dict:
    """(e) train_batch: 2 warm-up and 10 timed steps."""
    from repro_torch.training import optimizer as OPT
    base = torch.cuda.memory_allocated()
    step_fn, run = recsys_train_setup(cfg, model, dev)
    b, B = recsys_train_batch(cfg, model, dev, gen, step_fn, run)
    torch.cuda.reset_peak_memory_stats()      # not the batches that failed
    metrics, times = [], []
    for i in range(11):
        m, ms = event_ms(lambda: step_fn(model, run["opt"], b))
        metrics.append(m)
        if i >= 1:
            times.append(ms)
    peak = torch.cuda.max_memory_allocated() - base
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    lrs = torch.stack([m["lr"] for m in metrics]).cpu()
    want_lr = OPT.make_schedule(run["oc"])(torch.arange(
        2, len(metrics) + 2, dtype=torch.int32, device=dev)).cpu()
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"(e) {cfg.name}: non-finite loss or grad_norm: {losses} {gnorms}")
    check(bool(torch.equal(lrs, want_lr)), f"(e) {cfg.name}: lr sequence "
          f"{lrs.tolist()} != the schedule {want_lr.tolist()}")
    ms = statistics.median(times)
    fwd, formula = recsys_dense_flops(cfg, B)
    tflops = 3 * fwd / (ms / 1e3) / 1e12
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[recsys] (e) {cfg.name} train_batch: batch {B}"
        + (f" (of {RECSYS_SIZES['train']})" if B != RECSYS_SIZES["train"]
           else "") + f", {n_params / 1e6:.2f}M params, OptConfig(lr=1e-3) "
        f"(row-wise Adagrad on the tables, AdamW elsewhere): 2 warm-up + "
        f"{len(times)} timed steps, median {ms:.1f} ms/step (min "
        f"{min(times):.1f}, max {max(times):.1f}), "
        f"{B / (ms / 1e3):.1f} examples/s; 3 x {fwd:.4e} dense FLOPs "
        f"({formula}) = {tflops:.2f} TFLOP/s; peak device memory "
        f"{peak / 1e9:.2f} GB above the model; losses "
        + " ".join(f"{x:.4f}" for x in losses[1:]) + "; grad_norms "
        + " ".join(f"{x:.3f}" for x in gnorms[1:]) + " finite; lr == "
        "schedule")
    return dict(batch=B, ms=ms, ex_s=B / (ms / 1e3), tflops=tflops,
                peak_gb=peak / 1e9)


def recsys_path(args, dev) -> dict:
    """Phase 4m: the recsys family, (a) card vs CPU at the tests' sizes,
    then each arch at its full config (dlrm-mlperf capped): (b) serve_p99,
    (c) serve_bulk, (d) retrieval_cand, (e) train_batch. Its profiles run
    last (``recsys_profiles``)."""
    from repro_torch.configs import RECSYS_ARCHS, get_config
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.models.recsys import nets as R

    torch.cuda.empty_cache()
    log(f"[recsys] device memory held by earlier phases: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    t0 = time.perf_counter()
    DSP.reset_counts()
    res = {"a": recsys_card_vs_cpu(args, dev)}
    capped, full = recsys_config("dlrm-mlperf"), get_config("dlrm-mlperf")
    gb = lambda c: sum(c.vocab_sizes) * c.embed_dim * 4 / 1e9  # noqa: E731
    log(f"[recsys] reductions: dlrm-mlperf's 26 fields capped at "
        f"{RECSYS_ROW_CAP} rows, {sum(capped.vocab_sizes)} rows "
        f"({gb(capped):.2f} GB) of {sum(full.vocab_sizes)} ({gb(full):.1f} "
        "GB, four cards), widths unchanged; weights random from --seed, "
        "data synthetic")
    for arch in RECSYS_ARCHS:
        cfg = recsys_config(arch)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        t1 = time.perf_counter()
        model = R.init_params(cfg, gen, dev)
        torch.cuda.synchronize()
        tables = sum(p.numel() * 4 for n, p in model.named_parameters()
                     if n in ("emb.big", "emb.small", "items"))
        n_params = sum(p.numel() for p in model.parameters())
        item = R._item_field(cfg) if arch != "bert4rec" else "items"
        log(f"[recsys] {arch}: {n_params / 1e6:.2f}M params, tables "
            f"{tables / 1e9:.3f} GB f32, item field {item}, made on the card "
            f"in {time.perf_counter() - t1:.2f}s")
        r = recsys_serve(cfg, model, dev, gen)
        r["ret"] = recsys_retrieval(cfg, model, dev, gen)
        r["train"] = recsys_train(cfg, model, dev, gen)
        res[arch] = r
        del model
        gc.collect()
        torch.cuda.empty_cache()
    res["counts"] = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    res["seconds"] = time.perf_counter() - t0
    log(f"[recsys] phase 4m took {res['seconds']:.1f}s")
    return res


def recsys_profiles(args, dev, res) -> dict:
    """4m's profiles, last in the run: for each arch at its (e) batch, one
    train step split by phase (forward, backward, update; wall by CUDA
    events, then device time by kind under ``torch.profiler``) and one
    whole step under ``torch.profiler`` (busy share and GEMM share of
    (e)'s median step)."""
    from repro_torch.configs import RECSYS_ARCHS
    from repro_torch.models.recsys import nets as R
    out = {}
    for arch in RECSYS_ARCHS:
        cfg = recsys_config(arch)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        model = R.init_params(cfg, gen, dev)
        step_fn, run = recsys_train_setup(cfg, model, dev)
        b = recsys_batch(cfg, res[arch]["train"]["batch"], dev, gen, "train")
        step_fn(model, run["opt"], b)                        # warm-up
        wall = lm_step_phases(run, b, event_ms, run["loss_fn"])
        _, whole = profile_device_time(lambda: step_fn(model, run["opt"], b))
        phases = lm_step_phases(run, b, profile_device_time, run["loss_fn"])
        busy = sum(whole.values())
        ms = res[arch]["train"]["ms"]
        out[arch] = dict(busy=busy / ms, gemm=whole["gemm"] / busy,
                         phases={k: sum(v.values())
                                 for k, v in phases.items()})
        log(f"[recsys] (e) {arch} batch {res[arch]['train']['batch']}: one "
            f"train step under torch.profiler: " + busy_line(whole, ms)
            + " (of (e)'s median unprofiled step); by phase: "
            + phases_line(wall, phases))
        del model, run, b
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4n: the GNN family
# ---------------------------------------------------------------------------

# the cells' shapes (configs GNN_SHAPES) and the timed steps of (b), (c)
GNN_SIZES = dict(warmup=2, timed=5, batch_nodes=(1024, 512, 256),
                 mol_classes=1, sm_classes=47, lg_classes=41)
GNN_SCATTER = ("scatter", "index_add", "indexfunc", "index_put", "atomic")
GNN_GATHER = ("index_select", "indexselect", "gather", "index_kernel")
GNN_ELEMENTWISE = ("elementwise", "vectorized", "unrolled", "reduce",
                   "cat", "copy")


def gnn_config(variant: str):
    """``launch/cells.py``'s GNN cell config: equiformer-v2 at full width,
    bf16 messages, the fused rotation off ("base") or on ("opt")."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("equiformer-v2"),
                               msg_dtype="bfloat16",
                               fused_rotation=(variant == "opt"))


def gnn_reduced(**over):
    """The CPU tests' size (``tests/test_archs.py``'s ``reduced_gnn``: 2
    layers, d 16, l_max 3, m_max 2, 4 heads, rbf 8), float32."""
    from repro_torch.configs import get_config
    kw = dict(n_layers=2, d_hidden=16, l_max=3, m_max=2, n_heads=4,
              d_edge_rbf=8, remat=False)
    kw.update(over)
    return dataclasses.replace(get_config("equiformer-v2"), **kw)


def gnn_flops(cfg, n_edges: int) -> tuple:
    """(FLOPs of one train step, the formula): ``launch/cells.py``'s
    ``_gnn_flops(cfg, n_edges, train=True)``, per layer and edge 3 SO(2)
    convolutions and 2 rotation applies, times 3 for the backward."""
    from repro_torch.launch.cells import _gnn_flops
    per_edge = _gnn_flops(cfg, 1, True)
    formula = (f"3 x L x E x (3 conv + rot), conv = 2 (n0 C)^2 + sum_m 8 "
               f"((n0 - m) C)^2, rot = 4 C sum_l (2l+1)^2 (L "
               f"{cfg.n_layers}, C {cfg.d_hidden}, n0 {cfg.l_max + 1}, m_max "
               f"{cfg.m_max}): {per_edge / 1e9:.4f} GFLOP per edge")
    return _gnn_flops(cfg, n_edges, True), formula


def gnn_pos(gen, shape: tuple, dev) -> torch.Tensor:
    """Positions uniform in [-2, 2]^3: every pair lies within 6.93 of each
    other, inside the model's 8.0 radial cutoff, as the edges of a radius
    graph do (``gnn_cutoff_demo`` shows what edges past it do)."""
    return torch.rand(shape + (3,), generator=gen, device=dev) * 4 - 2


def gnn_graph(gen, n: int, e: int, f: int, dev) -> dict:
    """A random graph on ``dev``: features, positions (``gnn_pos``), COO
    edges, all edges live."""
    return {"feat": torch.randn((n, f), generator=gen, device=dev),
            "pos": gnn_pos(gen, (n,), dev),
            "src": torch.randint(0, n, (e,), generator=gen, device=dev),
            "dst": torch.randint(0, n, (e,), generator=gen, device=dev),
            "emask": torch.ones(e, dtype=torch.bool, device=dev)}


def gnn_node_loss(cfg, b: dict):
    """``node_ce_loss`` over ``b``'s graph (``LocalEdges``)."""
    from repro_torch.models.gnn import equiformer_v2 as E
    from repro_torch.models.gnn.graph import LocalEdges
    plan = LocalEdges(b["src"], b["dst"], b["emask"], b["feat"].shape[0])
    return lambda m, _: E.node_ce_loss(cfg, m, plan, b["feat"], b["pos"],
                                       b["labels"], b["lmask"])


def gnn_card_vs_cpu(args, dev) -> dict:
    """(a) the CPU tests' size, float32: one seeded model on the host
    copied to the card; forward, ``node_ce_loss`` and every gradient, the
    molecule loss over 4 graphs, the fused against the unfused forward,
    and the l=0 outputs under a random global rotation, on the card."""
    import copy
    from repro_torch.models.gnn import equiformer_v2 as E
    from repro_torch.models.gnn.graph import LocalEdges

    n, e, f, n_out = 24, 80, 10, 5
    gen = torch.Generator().manual_seed(args.seed)
    b = gnn_graph(gen, n, e, f, "cpu")
    b["src"][:2] = b["dst"][:2]                    # zero-length edges
    b["labels"] = torch.randint(0, n_out, (n,), generator=gen)
    b["lmask"] = torch.rand(n, generator=gen) > 0.25
    mol = {"feat": torch.randn((4, 6, f), generator=gen),
           "pos": torch.randn((4, 6, 3), generator=gen) * 2,
           "src": torch.randint(0, 6, (4, 10), generator=gen),
           "dst": torch.randint(0, 6, (4, 10), generator=gen),
           "emask": torch.rand((4, 10), generator=gen) > 0.2,
           "target": torch.randn(4, generator=gen)}
    to = lambda x: {k: v.to(dev) for k, v in x.items()}  # noqa: E731
    out, outs = {}, {}
    for fused in (False, True):
        cfg = gnn_reduced(fused_rotation=fused)
        cpu = E.init_params(cfg, f, n_out,
                            torch.Generator().manual_seed(args.seed),
                            device="cpu")
        gpu = copy.deepcopy(cpu).to(dev)
        res = {}
        for side, model, bb in (("cpu", cpu, b), ("card", gpu, to(b))):
            plan = LocalEdges(bb["src"], bb["dst"], bb["emask"], n)
            with torch.no_grad():
                fwd = E.forward(cfg, model, plan, bb["feat"], bb["pos"])
            loss = E.node_ce_loss(cfg, model, plan, bb["feat"], bb["pos"],
                                  bb["labels"], bb["lmask"])
            loss.backward()
            res[side] = (fwd.cpu(), loss.item(), {
                k: p.grad.cpu() for k, p in model.named_parameters()})
        (fc, lc, g_cpu), (fg, lg, g_card) = res["cpu"], res["card"]
        try:
            torch.testing.assert_close(fg, fc, rtol=1e-5, atol=1e-5)
        except AssertionError as err:
            fail(f"(a) fused={fused}: card forward != CPU (rtol 1e-5, atol "
                 f"1e-5): {err}")
        check(np.isfinite(lg) and abs(lg - lc) <= 1e-5 * abs(lc),
              f"(a) fused={fused}: card loss {lg!r} != CPU loss {lc!r} "
              "(rtol 1e-5)")
        g_err = 0.0
        for name, want in g_cpu.items():
            try:
                torch.testing.assert_close(g_card[name], want, rtol=1e-3,
                                           atol=1e-6)
            except AssertionError as err:
                fail(f"(a) fused={fused}: grad {name}: card != CPU (rtol "
                     f"1e-3, atol 1e-6): {err}")
            g_err = max(g_err, float((g_card[name] - want).abs().max()))
        ml = [E.batched_graph_energy_loss(cfg, m, **bb).item() for m, bb in
              ((cpu, mol), (gpu, to(mol)))]
        check(abs(ml[1] - ml[0]) <= 1e-5 * abs(ml[0]),
              f"(a) fused={fused}: molecule loss card {ml[1]!r} != CPU "
              f"{ml[0]!r} (rtol 1e-5)")
        q, _ = torch.linalg.qr(torch.randn((3, 3), generator=gen,
                                           dtype=torch.float64))
        q = (q * torch.sign(torch.linalg.det(q))).float().to(dev)
        bg = to(b)
        plan = LocalEdges(bg["src"], bg["dst"], bg["emask"], n)
        with torch.no_grad():
            rot = E.forward(cfg, gpu, plan, bg["feat"], bg["pos"] @ q.T)
        try:
            torch.testing.assert_close(rot.cpu(), fg, rtol=1e-3, atol=1e-4)
        except AssertionError as err:
            fail(f"(a) fused={fused}: l=0 outputs moved under a global "
                 f"rotation (rtol 1e-3, atol 1e-4): {err}")
        outs[fused] = fg
        out[fused] = dict(fwd_abs=float((fg - fc).abs().max()),
                          loss_rel=abs(lg - lc) / abs(lc), grad_abs=g_err,
                          mol_rel=abs(ml[1] - ml[0]) / abs(ml[0]),
                          rot_abs=float((rot.cpu() - fg).abs().max()))
    try:
        torch.testing.assert_close(outs[True], outs[False], rtol=1e-5,
                                   atol=1e-5)
    except AssertionError as err:
        fail(f"(a) fused forward != unfused on the card (rtol 1e-5, atol "
             f"1e-5): {err}")
    fu = float((outs[True] - outs[False]).abs().max())
    for fused, o in out.items():
        log(f"[gnn] (a) fused={fused} (CPU tests' size, f32), card vs CPU: "
            f"forward max abs err {o['fwd_abs']:.2e} (rtol 1e-5, atol "
            f"1e-5); node_ce loss rel err {o['loss_rel']:.2e} (rtol 1e-5); "
            f"grads max abs err {o['grad_abs']:.2e} (rtol 1e-3, atol 1e-6); "
            f"molecule loss (4 graphs) rel err {o['mol_rel']:.2e} (rtol "
            f"1e-5); l=0 outputs under a global rotation max abs err "
            f"{o['rot_abs']:.2e} (rtol 1e-3, atol 1e-4)")
    log(f"[gnn] (a) fused vs unfused forward on the card: max abs err "
        f"{fu:.2e} (rtol 1e-5, atol 1e-5)")
    return dict(out, fused_abs=fu)


def gnn_molecule_batch(gen, dev) -> dict:
    """``molecule``: 128 graphs x 30 nodes x 64 edges, 16 features, one
    energy target a graph."""
    G, NN, EE, F = 128, 30, 64, 16
    return {"feat": torch.randn((G, NN, F), generator=gen, device=dev),
            "pos": gnn_pos(gen, (G, NN), dev),
            "src": torch.randint(0, NN, (G, EE), generator=gen, device=dev),
            "dst": torch.randint(0, NN, (G, EE), generator=gen, device=dev),
            "emask": torch.ones((G, EE), dtype=torch.bool, device=dev),
            "target": torch.randn(G, generator=gen, device=dev)}


def gnn_sm_batch(gen, dev) -> dict:
    """``full_graph_sm``: 2708 nodes, 10556 edges, 1433 features, 47
    classes, every node labelled."""
    b = gnn_graph(gen, 2708, 10556, 1433, dev)
    b["labels"] = torch.randint(0, GNN_SIZES["sm_classes"], (2708,),
                                generator=gen, device=dev)
    b["lmask"] = torch.ones(2708, dtype=torch.bool, device=dev)
    return b


def gnn_big_graph(args) -> tuple:
    """``minibatch_lg``'s graph: ``random_graph(232965, 492)`` (114.6M
    edges) and ``CSRGraph.from_coo``, on the host, with the seconds of
    each."""
    from repro_torch.configs import GNN_SHAPES
    from repro_torch.models.gnn import sampler as SMP
    shape = {s.name: s for s in GNN_SHAPES}["minibatch_lg"]
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    src, dst = SMP.random_graph(shape.n_nodes,
                                round(shape.n_edges / shape.n_nodes), rng)
    t1 = time.perf_counter()
    g = SMP.CSRGraph.from_coo(src, dst, shape.n_nodes)
    t2 = time.perf_counter()
    n_edges = len(src)
    del src, dst
    return g, rng, shape, dict(n_edges=n_edges, gen_s=t1 - t0,
                               csr_s=t2 - t1)


def gnn_lg_batch(g, rng, shape, batch_nodes: int, gen, dev) -> tuple:
    """(batch, sample seconds, live nodes, live edges): seeds drawn from
    ``rng``, a fanout-(15, 10) subgraph padded to ``max_subgraph_shape``,
    602 features, 41 classes, the loss over the seeds (positions [0,
    batch_nodes))."""
    from repro_torch.models.gnn import sampler as SMP
    t0 = time.perf_counter()
    seeds = rng.choice(g.n_nodes, batch_nodes, replace=False)
    sub = SMP.sample_subgraph(g, seeds, tuple(shape.fanout), rng)
    secs = time.perf_counter() - t0
    n_max = len(sub["nodes"])
    b = {"feat": torch.randn((n_max, shape.d_feat), generator=gen,
                             device=dev),
         "pos": gnn_pos(gen, (n_max,), dev),
         "labels": torch.randint(0, GNN_SIZES["lg_classes"], (n_max,),
                                 generator=gen, device=dev),
         "lmask": torch.arange(n_max, device=dev) < sub["n_seeds"]}
    for k, v in (("src", "src"), ("dst", "dst"), ("emask", "edge_mask")):
        b[k] = torch.from_numpy(sub[v]).to(dev)
    return (b, secs, int(sub["node_mask"].sum()),
            int(sub["edge_mask"].sum()))


def gnn_train(cfg, model, loss_fn, batch, n_edges: int, what: str) -> dict:
    """2 warm-up and 5 timed steps (CUDA events) of ``make_train_step``
    with ``OptConfig()`` (``cells.py``'s settings, AdamW on every leaf):
    every loss and grad_norm finite, the lr the schedule's."""
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train_loop import make_train_step
    oc = OPT.OptConfig()
    params = dict(model.named_parameters())
    labels = OPT.default_labels(params)
    check(set(labels.values()) == {"adamw"}, f"{what}: a GNN parameter is "
          "not AdamW")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt = OPT.init_opt_state(params, labels)
    step_fn = make_train_step(loss_fn, oc, labels=labels)
    metrics, times = [], []
    n_steps = GNN_SIZES["warmup"] + GNN_SIZES["timed"]
    for i in range(n_steps):
        m, ms = event_ms(lambda: step_fn(model, opt, batch))
        metrics.append(m)
        if i >= GNN_SIZES["warmup"]:
            times.append(ms)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    lrs = torch.stack([m["lr"] for m in metrics])
    want_lr = OPT.make_schedule(oc)(torch.arange(
        1, n_steps + 1, dtype=torch.int32, device=lrs.device)).cpu()
    lrs = lrs.cpu()
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"{what}: non-finite loss or grad_norm: {losses} {gnorms}")
    check(bool(torch.equal(lrs, want_lr)), f"{what}: lr sequence "
          f"{lrs.tolist()} != the schedule {want_lr.tolist()}")
    ms = statistics.median(times)
    flops, formula = gnn_flops(cfg, n_edges)
    del opt
    return dict(ms=ms, min=min(times), max=max(times),
                edges_s=n_edges / (ms / 1e3), tflops=flops / (ms / 1e3) / 1e12,
                flops=flops, formula=formula, peak_gb=peak / 1e9,
                above_gb=(peak - base) / 1e9, losses=losses, gnorms=gnorms)


def gnn_line(r: dict) -> str:
    return (f"2 warm-up + {GNN_SIZES['timed']} timed steps, median "
            f"{r['ms']:.1f} ms/step (min {r['min']:.1f}, max {r['max']:.1f}),"
            f" {r['edges_s']:.4e} edges/s, {r['flops']:.4e} FLOPs "
            f"= {r['tflops']:.2f} TFLOP/s; peak device memory "
            f"{r['peak_gb']:.2f} GB ({r['above_gb']:.2f} GB above the model "
            f"and batch); losses " + " ".join(f"{x:.4f}" for x in r["losses"])
            + "; grad_norms " + " ".join(f"{x:.3f}" for x in r["gnorms"])
            + " finite; lr == schedule")


def gnn_fresh(cfg, d_feat: int, n_out: int, args, dev):
    from repro_torch.models.gnn import equiformer_v2 as E
    gc.collect()
    torch.cuda.empty_cache()
    return E.init_params(cfg, d_feat, n_out, torch.Generator(
        device=dev).manual_seed(args.seed), dev)


def gnn_cutoff_demo(cfg, args, dev, gen) -> dict:
    """The reference model's behaviour on edges past its radial cutoff,
    shown and not timed: the ``molecule`` batch with positions normal x 2
    (pairs up to ~14 apart), one forward and backward at full width. A
    node whose incoming edges all lie past the cutoff gets l>0 features
    of ~0 that are not 0 (the Gaussian RBF of a distance past 8.0 is
    ~exp(-64)); the per-l RMS norm then divides by ~sqrt(eps) at each
    layer, and the gradients grow by that factor layer after layer. The
    port follows ``repro``'s arithmetic op for op (the CPU tests hold
    both at the reduced size)."""
    from repro_torch.models.gnn import equiformer_v2 as E
    from repro_torch.training import optimizer as OPT
    model = gnn_fresh(cfg, 16, GNN_SIZES["mol_classes"], args, dev)
    b = gnn_molecule_batch(gen, dev)
    b["pos"] = torch.randn(b["pos"].shape, generator=gen, device=dev) * 2
    loss = E.batched_graph_energy_loss(cfg, model, **b)
    loss.backward()
    gn = float(OPT.global_norm(p.grad for p in model.parameters()))
    top = max(model.named_parameters(),
              key=lambda kv: float(kv[1].grad.float().abs().max()))
    d = (b["pos"].gather(1, b["dst"][..., None].expand(-1, -1, 3))
         - b["pos"].gather(1, b["src"][..., None].expand(-1, -1, 3)))
    far = (d.norm(dim=-1) > 8.0).sum().item()
    out = dict(loss=loss.item(), grad_norm=gn, top=top[0],
               top_abs=float(top[1].grad.float().abs().max()), far=far)
    del model, b, loss
    return out


def gnn_lg_run(cfg, variant, args, dev, graph, gen, batches) -> dict:
    """(c) ``minibatch_lg`` at the largest of ``batch_nodes`` whose
    warm-up step fits, on the subgraph ``batches`` holds for that size
    (sampled at first use), so base and opt train on the same one."""
    from repro_torch.models.gnn import sampler as SMP
    g, rng, shape, _ = graph
    for bn in GNN_SIZES["batch_nodes"]:
        if bn not in batches:
            continue
        if batches[bn] is None:
            batches[bn] = gnn_lg_batch(g, rng, shape, bn, gen, dev)
        b, secs, n_live, e_live = batches[bn]
        model = gnn_fresh(cfg, shape.d_feat, GNN_SIZES["lg_classes"], args,
                          dev)
        n_max, e_max = SMP.max_subgraph_shape(bn, tuple(shape.fanout))
        try:
            r = gnn_train(cfg, model, gnn_node_loss(cfg, b), b, e_max,
                          f"(c) minibatch_lg {variant}")
        except torch.cuda.OutOfMemoryError:
            log(f"[gnn] (c) minibatch_lg {variant}: batch_nodes {bn} "
                f"(padded {n_max} nodes, {e_max} edges) does not fit")
            r = None
        del model, b
        if r is not None:
            r.update(batch_nodes=bn, n_max=n_max, e_max=e_max, n_live=n_live,
                     e_live=e_live, sample_s=secs)
            return r
        # outside the handler, whose traceback holds the step's tensors
        del batches[bn]
        gc.collect()
        torch.cuda.empty_cache()
    fail(f"(c) minibatch_lg {variant}: no batch_nodes of "
         f"{GNN_SIZES['batch_nodes']} fits")


def gnn_path(args, dev) -> dict:
    """Phase 4n: the GNN family, (a) card vs CPU at the tests' size, then
    equiformer-v2 at full width, bf16 messages, base and opt: (b)
    ``molecule`` and ``full_graph_sm``, (c) ``minibatch_lg``. Its profile
    runs last (``gnn_profiles``)."""
    from repro_torch.configs import GNN_SHAPES
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.models.gnn import equiformer_v2 as E

    torch.cuda.empty_cache()
    log(f"[gnn] device memory held by earlier phases: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    t0 = time.perf_counter()
    DSP.reset_counts()
    res = {"a": gnn_card_vs_cpu(args, dev)}
    base_cfg = gnn_config("base")
    model = gnn_fresh(base_cfg, 16, 1, args, dev)
    n_params = sum(p.numel() for p in model.parameters())
    del model
    res["n_params"] = n_params
    _, formula = gnn_flops(base_cfg, 1)
    log(f"[gnn] equiformer-v2: {base_cfg.n_layers} layers, "
        f"{base_cfg.d_hidden} sphere channels, l_max {base_cfg.l_max}, "
        f"m_max {base_cfg.m_max}, {base_cfg.n_heads} heads, "
        f"{n_params / 1e6:.2f}M params (molecule head); bf16 messages, "
        f"remat per layer; FLOPs by cells.py's _gnn_flops: {formula}; "
        "weights random from --seed, data synthetic")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for variant in ("base", "opt"):
        cfg = gnn_config(variant)
        model = gnn_fresh(cfg, 16, GNN_SIZES["mol_classes"], args, dev)
        mb = gnn_molecule_batch(gen, dev)
        r = gnn_train(cfg, model, lambda m, b: E.batched_graph_energy_loss(
            cfg, m, **b), mb, 128 * 64, f"(b) molecule {variant}")
        res[f"mol_{variant}"] = r
        log(f"[gnn] (b) molecule {variant} (128 graphs x 30 nodes x 64 "
            "edges as one disjoint union, graph_energy_loss): "
            + gnn_line(r))
        del model, mb
        model = gnn_fresh(cfg, 1433, GNN_SIZES["sm_classes"], args, dev)
        sb = gnn_sm_batch(gen, dev)
        r = gnn_train(cfg, model, gnn_node_loss(cfg, sb), sb, 10556,
                      f"(b) full_graph_sm {variant}")
        res[f"sm_{variant}"] = r
        log(f"[gnn] (b) full_graph_sm {variant} (2708 nodes, 10556 edges, "
            "1433 features, 47 classes, node_ce_loss): " + gnn_line(r))
        del model, sb
    demo = gnn_cutoff_demo(gnn_config("base"), args, dev, gen)
    res["demo"] = demo
    log(f"[gnn] (b) molecule base with positions normal x 2 instead "
        f"({demo['far']} of 8192 edges past the 8.0 cutoff), one forward "
        f"and backward, not timed: loss {demo['loss']:.4f}, grad_norm "
        f"{demo['grad_norm']:.4e} (largest gradient {demo['top_abs']:.4e}, "
        f"{demo['top']}): the reference model's gradients grow by ~1/sqrt("
        "eps) a layer at nodes whose l>0 features are ~0 but not 0; the "
        "timed steps keep every edge inside the cutoff")
    graph = gnn_big_graph(args)
    gi = graph[3]
    res["graph"] = gi
    log(f"[gnn] (c) minibatch_lg graph on the host: random_graph(232965, "
        f"492): {gi['n_edges']} edges in {gi['gen_s']:.1f}s; "
        f"CSRGraph.from_coo in {gi['csr_s']:.1f}s (numpy, outside the "
        "steps)")
    batches = dict.fromkeys(GNN_SIZES["batch_nodes"])
    for variant in ("base", "opt"):
        cfg = gnn_config(variant)
        r = gnn_lg_run(cfg, variant, args, dev, graph, gen, batches)
        res[f"c_{variant}"] = r
        red = ("" if r["batch_nodes"] == GNN_SIZES["batch_nodes"][0] else
               f" (reduced from {GNN_SIZES['batch_nodes'][0]}: the larger "
               "batches do not fit one card)")
        log(f"[gnn] (c) minibatch_lg {variant}: batch_nodes "
            f"{r['batch_nodes']}{red}, fanout (15, 10), padded "
            f"{r['n_max']} nodes / {r['e_max']} edges ({r['n_live']} / "
            f"{r['e_live']} live), sampled in {r['sample_s']:.2f}s on the "
            "host; " + gnn_line(r))
    del graph, batches
    gc.collect()
    torch.cuda.empty_cache()
    shape_p = {s.name: s for s in GNN_SHAPES}["ogb_products"]
    cfgb = base_cfg
    edge_gb = shape_p.n_edges * cfgb.n_sph * cfgb.d_hidden * 2 / 1e9
    node_gb = shape_p.n_nodes * cfgb.n_sph * cfgb.d_hidden * 4 / 1e9
    log(f"[gnn] ogb_products ({shape_p.n_nodes} nodes, {shape_p.n_edges} "
        f"edges, d_feat {shape_p.d_feat}): not run: one bf16 edge tensor "
        f"[E, {cfgb.n_sph}, {cfgb.d_hidden}] is {edge_gb:.1f} GB and the f32 "
        f"node features {node_gb:.1f} GB a layer, against 80 GB on one "
        "card; it needs the vertex-cut over several cards "
        "(ShardedEdges.exchange's all_to_all), which waits for the "
        "sharded mesh code")
    res["counts"] = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    check(not any(res["counts"].values()), "phase 4n launched a kernel of "
          f"the port: {res['counts']} (the GNN family has none)")
    res["seconds"] = time.perf_counter() - t0
    log(f"[gnn] phase 4n took {res['seconds']:.1f}s")
    return res


def gnn_profile_kinds(fn) -> tuple:
    """(``fn()``, device ms by kind: gemm, scatter, gather, elementwise,
    other) of one call under ``torch.profiler`` (``profiled``)."""
    out, events = profiled(fn)
    by = {"gemm": 0.0, "scatter": 0.0, "gather": 0.0, "elementwise": 0.0,
          "other": 0.0}
    for e in events:
        name = e.name.lower()
        kind = ("gemm" if any(t in name for t in GEMM_NAMES) else
                "scatter" if any(t in name for t in GNN_SCATTER) else
                "gather" if any(t in name for t in GNN_GATHER) else
                "elementwise" if any(t in name for t in GNN_ELEMENTWISE)
                else "other")
        by[kind] += e.device_time / 1e3
    check(sum(by.values()) > 0, "torch.profiler recorded no device time")
    return out, by


def gnn_profiles(args, dev, res) -> dict:
    """4n's profile, last in the run: one ``full_graph_sm`` train step
    (base) under ``torch.profiler``: busy share of (b)'s median step,
    GEMM, scatter, gather and elementwise shares."""
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train_loop import make_train_step
    cfg = gnn_config("base")
    model = gnn_fresh(cfg, 1433, GNN_SIZES["sm_classes"], args, dev)
    sb = gnn_sm_batch(torch.Generator(device=dev).manual_seed(args.seed),
                      dev)
    opt = OPT.init_opt_state(dict(model.named_parameters()))
    step_fn = make_train_step(gnn_node_loss(cfg, sb), OPT.OptConfig())
    step_fn(model, opt, sb)                            # warm-up
    _, by = gnn_profile_kinds(lambda: step_fn(model, opt, sb))
    busy = sum(by.values())
    ms = res["sm_base"]["ms"]
    log(f"[gnn] (b) full_graph_sm base: one train step under "
        f"torch.profiler: device kernel time {busy:.1f} ms "
        f"({100 * busy / ms:.1f}% of (b)'s median {ms:.1f} ms): "
        + ", ".join(f"{k} {v:.1f} ms ({100 * v / busy:.1f}%)"
                    for k, v in by.items()))
    del model, opt, sb
    gc.collect()
    torch.cuda.empty_cache()
    return dict(busy=busy / ms, **{k: v / busy for k, v in by.items()})


def gnn_summary(gn: dict) -> str:
    """Phase 4n's ``[summary]`` line."""
    a = gn["a"]
    cells = "; ".join(
        f"{name} {v} {gn[f'{k}_{v}']['ms']:.1f} ms/step "
        f"{gn[f'{k}_{v}']['edges_s']:.4e} edges/s "
        f"{gn[f'{k}_{v}']['tflops']:.2f} TFLOP/s peak "
        f"{gn[f'{k}_{v}']['peak_gb']:.2f} GB"
        for k, name in (("mol", "molecule"), ("sm", "full_graph_sm"),
                        ("c", "minibatch_lg")) for v in ("base", "opt"))
    return (f"[summary] gnn (a) card vs CPU, reduced f32: forward max abs "
            f"err {max(a[f]['fwd_abs'] for f in (False, True)):.2e}, loss "
            f"rel err {max(a[f]['loss_rel'] for f in (False, True)):.2e}, "
            f"grad max abs err "
            f"{max(a[f]['grad_abs'] for f in (False, True)):.2e}; "
            f"equiformer-v2 {gn['n_params'] / 1e6:.2f}M params, bf16 "
            f"messages: {cells}; minibatch_lg batch_nodes "
            f"{gn['c_base']['batch_nodes']}/{gn['c_opt']['batch_nodes']}, "
            f"graph {gn['graph']['gen_s']:.1f}s + CSR "
            f"{gn['graph']['csr_s']:.1f}s on the host; full_graph_sm busy "
            f"{100 * gn['f']['busy']:.1f}% (gemm "
            f"{100 * gn['f']['gemm']:.1f}%, scatter "
            f"{100 * gn['f']['scatter']:.1f}%, elementwise "
            f"{100 * gn['f']['elementwise']:.1f}%); ogb_products not run; "
            f"phase 4n {gn['seconds']:.1f}s")


# ---------------------------------------------------------------------------
# phase 4o: the cells (launch/cells.py)
# ---------------------------------------------------------------------------

CELL_SIZES = dict(timed=3, corpus=131072, check_queries=8, lm_batch=1)


def cell_run(cell, timed: int, launched: dict) -> tuple:
    """(median ms, all ms, the warm-up call's output) of ``cell.fn`` on
    its arguments: one warm-up call, then ``timed`` calls each timed by
    CUDA events. The kernel launches of these calls are added to
    ``launched``."""
    from repro_torch.kernels import dispatch as DSP
    before = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    out = cell.fn(*cell.args)
    torch.cuda.synchronize()
    times = [event_ms(lambda: cell.fn(*cell.args))[1]
             for _ in range(timed)]
    for k in DSP.KERNELS:
        launched[k] += DSP.launch_count(k) - before[k]
    return statistics.median(times), times, out


def cell_line(cell, ms: float, times: list) -> str:
    return (f"{ms:.3f} ms (median of {len(times)}: "
            + " ".join(f"{t:.3f}" for t in times)
            + f"), model_flops {cell.model_flops:.4e} = "
            f"{cell.model_flops / (ms / 1e3) / 1e12:.2f} TFLOP/s")


def cells_meta(total: int) -> dict:
    """(a) every cell of ``get_cells(ALL_ARCHS)`` x its variants on
    ``meta``: parameters, argument bytes, model_flops, and whether the
    arguments alone exceed the card's memory; nothing is allocated."""
    from repro_torch.configs import ALL_ARCHS, get_cells, get_config
    from repro_torch.launch import cells as C
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    rows = []
    for arch, shape in get_cells(ALL_ARCHS):
        for variant in C.variants(arch, shape):
            c = C.build_cell(arch, shape, "meta", variant)
            model = c.args[0]
            n_params = (sum(p.numel() for p in model.parameters())
                        if isinstance(model, torch.nn.Module) else 0)
            nb = C.arg_bytes(c)
            extra = ""
            cfg, sh = get_config(arch), get_shape(arch, shape)
            if sh.kind == "train" and cfg.family == "lm":
                f, _ = lm_step_flops(cfg, sh.global_batch, sh.seq_len)
                extra = (f"; lm_step_flops (8 N T, with the remat forward) "
                         f"{f:.4e}")
            elif sh.kind == "train" and cfg.family == "retriever":
                f, _ = train_step_flops(cfg, sh.global_batch,
                                        cfg.max_query_tokens)
                extra = (f"; train_step_flops (recompute, query tower, score "
                         f"matrix) {f:.4e}")
            over = nb > total
            rows.append(dict(arch=arch, shape=shape, variant=variant,
                             gb=nb / 1e9, over=over))
            log(f"[cells] (a) {arch} {shape} {variant}: {n_params / 1e6:.2f}M"
                f" params, arguments {nb / 1e9:.2f} GB "
                f"({'over' if over else 'within'} the card's "
                f"{total / 1e9:.1f} GB), model_flops {c.model_flops:.4e}"
                + (f", {c.note}" if c.note else "") + extra)
    check(len(rows) == 101, f"(a) {len(rows)} cells, expected 101")
    check(torch.cuda.memory_allocated() == held,
          "(a) building the cells on meta allocated device memory")
    n_over = sum(r["over"] for r in rows)
    dt = time.perf_counter() - t0
    log(f"[cells] (a) {len(rows)} cells on meta in {dt:.1f}s, nothing "
        f"allocated; {n_over} have arguments over the card's memory")
    return dict(rows=rows, n_over=n_over, seconds=dt)


def get_shape(arch: str, shape: str):
    from repro_torch.configs import get_shapes
    return get_shapes(arch)[shape]


def cells_index(dev, gen, launched: dict) -> dict:
    """(b) the three retrievers' ``index_1m`` cells at 256 pages, under
    ``torch.inference_mode``: encode, hygiene, pooling through
    ``pool.cu``. The warm-up call's own encoder output is kept: its
    pooling through the kernel is held against ``pool_ref`` at phase 3's
    tolerance, and the cell's bfloat16 outputs against that output and
    ``pool_ref``'s, rounded, within one bfloat16 step."""
    from repro_torch.configs import PAPER_ARCHS
    from repro_torch.kernels import pooling as POPS
    from repro_torch.launch import cells as C
    out = {}
    for arch in PAPER_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        c = C.build_cell(arch, "index_1m", dev, generator=gen)
        model, patches = c.args
        cfg = model.cfg
        seen, encode = [], model.encode_pages

        def encode_kept(x):
            res = encode(x)
            if not seen:
                seen.append(res[0])
            return res

        model.encode_pages = encode_kept
        with torch.inference_mode():
            ms, times, res = cell_run(c, CELL_SIZES["timed"], launched)
            del model.encode_pages
            vis = seen[0][:, cfg.n_special:]
            pm = torch.as_tensor(POPS.pooling_matrix(cfg)).to(dev)
            mask = torch.ones(vis.shape[:2], device=dev)
            ref = POPS.pool_ref(vis, mask, pm)
            err = max_err(POPS.pool_pages_fused(vis, mask, pm), ref,
                          f"(b) {arch} index_1m pooling [256,"
                          f"{vis.shape[1]},{vis.shape[2]}], P "
                          f"{list(pm.shape)}", rtol=1e-5, atol=1e-5)
            check(tuple(res[1].shape) == (256, pm.shape[0], cfg.out_dim)
                  and all(bool(torch.isfinite(x.float()).all())
                          for x in res),
                  f"(b) {arch} index_1m: output not finite or not "
                  f"[256, {pm.shape[0]}, {cfg.out_dim}]")
            check(torch.equal(res[0], vis.to(torch.bfloat16)),
                  f"(b) {arch} index_1m: the cell's vectors are not its "
                  "encoder's output")
            want = ref.to(torch.bfloat16).float()
            off = (res[1].float() - want).abs()
            check(bool((off <= 2.0 ** -7 * want.abs() + 1e-6).all()),
                  f"(b) {arch} index_1m: the cell's pooled vectors are "
                  f"more than one bfloat16 step from pool_ref's (max "
                  f"{float(off.max()):.3e})")
        peak = torch.cuda.max_memory_allocated() / 1e9
        out[arch] = dict(ms=ms, err=err, peak_gb=peak,
                         tflops=c.model_flops / (ms / 1e3) / 1e12,
                         pages_s=256 / (ms / 1e3))
        log(f"[cells] (b) {arch} index_1m (256 pages, S {cfg.seq_len}, "
            f"{pm.shape[0]} pooled): " + cell_line(c, ms, times)
            + f", {256 / (ms / 1e3):.1f} pages/s, peak {peak:.2f} GB; the "
            f"cell's pooled output within one bf16 step of pool_ref's "
            f"(max {float(off.max()):.3e})")
        del c, model, patches, seen, vis, res, pm, mask, ref, want, off
        gc.collect()
        torch.cuda.empty_cache()
    return out


def cells_recsys_gnn(dev, gen, launched: dict, rs: dict, gn: dict) -> dict:
    """(b) dcn-v2's four cells (base) and ``retrieval_cand`` opt, and
    equiformer-v2's ``molecule`` (base), beside 4m's and 4n's times."""
    from repro_torch.launch import cells as C
    d = rs["dcn-v2"]
    runs = (("dcn-v2", "train_batch", "base", d["train"]["ms"],
             "4m (e) train_batch"),
            ("dcn-v2", "serve_p99", "base", d["p50"],
             "4m (b) p50, host clock"),
            ("dcn-v2", "serve_bulk", "base", d["bulk_ms"], "4m (c)"),
            ("dcn-v2", "retrieval_cand", "base", d["ret"]["1-stage"]["ms"],
             "4m (d) 1-stage"),
            ("dcn-v2", "retrieval_cand", "opt",
             d["ret"]["2-stage cand_proxy"]["ms"],
             "4m (d) 2-stage cand_proxy"),
            ("equiformer-v2", "molecule", "base", gn["mol_base"]["ms"],
             "4n (b) molecule base"))
    out = {}
    for arch, shape, variant, was, where in runs:
        c = C.build_cell(arch, shape, dev, variant, generator=gen)
        ms, times, res = cell_run(c, CELL_SIZES["timed"], launched)
        vals = res.values() if isinstance(res, dict) else (
            res if isinstance(res, tuple) else (res,))
        check(all(bool(torch.isfinite(v.float()).all()) for v in vals),
              f"(b) {arch} {shape} {variant}: non-finite output")
        out[f"{arch} {shape} {variant}"] = dict(
            ms=ms, was=was, tflops=c.model_flops / (ms / 1e3) / 1e12)
        log(f"[cells] (b) {arch} {shape} {variant}: " + cell_line(c, ms, times)
            + f"; {where} in this run: {was:.3f} ms")
        if shape == "molecule":
            out[f"{arch} {shape} {variant}"].update(
                molecule_ids_check(c, launched))
        del c, res, vals
        gc.collect()
        torch.cuda.empty_cache()
    return out


def molecule_ids_check(c, launched: dict) -> dict:
    """The molecule cell's steps again with its edge ids as int64 (4n's
    dtype; the cell has ``repro``'s int32), then as int32 once more, the
    same values and calls as the cell's timing: whether the id dtype or
    the extra warm-up explains a gap to 4n's step."""
    batch = c.args[2]
    ms = {}
    for dtype, key in ((torch.int64, "int64_ms"), (torch.int32, "int32_ms")):
        for k in ("src", "dst"):
            batch[k] = batch[k].to(dtype)
        ms[key], times, _ = cell_run(c, CELL_SIZES["timed"], launched)
        log(f"[cells] (b) equiformer-v2 molecule base, edge ids {dtype}, "
            f"after the calls above: " + cell_line(c, ms[key], times))
    return ms


def compare_search_cell(store, kern, q, qm, ids_k, sc_k,
                        what: str) -> tuple:
    """A search cell's kernel ranking (stages ``kern`` over the raw
    ``store``; ids_k, sc_k [n, k] of the queries ``q``) against the plain
    path on the card, ranked one deeper (``plus_one``), the scan chunked
    by 256 pages: ``compare_rankings`` for one stage, else
    ``compare_two_stage``. Returns (tie swaps, queries explained by
    cut-off ties)."""
    from repro_torch.core import multistage as MST
    from repro_torch.retrieval.engine import make_search_fn
    n_docs = int(store["initial"].shape[0])
    plain = MST.with_rerank_policy(MST.with_scan_policy(
        kern, use_kernel=False, chunk=256), rerank_kernel=False)
    ps, pi = make_search_fn(plus_one(plain), n_docs)(store, q, qm)
    ids_p, sc_p = pi.cpu().numpy(), ps.float().cpu().numpy()
    if len(kern) == 1:
        return compare_rankings(ids_k, sc_k, ids_p, sc_p, what), 0
    return compare_two_stage(
        store, np.arange(n_docs),
        lambda qq, mm, st: make_search_fn(st, n_docs)(store, qq, mm),
        kern, q, qm, ids_k, sc_k, ids_p, sc_p, what)


def cells_search(dev, gen, launched: dict) -> dict:
    """(c) colpali ``search_1m`` (stage1, base, opt) at a corpus cut to
    ``CELL_SIZES["corpus"]`` pages: 64 queries a call through the scan,
    rerank and int8 scan kernels; the first ``check_queries`` queries
    held against the plain path."""
    from repro_torch.launch import cells as C
    full = get_shape("colpali", "search_1m")
    full_gb = C.arg_bytes(C.build_cell("colpali", "search_1m", "meta")) / 1e9
    n = CELL_SIZES["corpus"]
    shape = dataclasses.replace(full, dims={**full.dims, "corpus": n})
    log(f"[cells] (c) reduced: corpus {full.corpus} -> {n}, "
        f"{full_gb:.2f} GB of arguments at 1M")
    out = {}
    nq = CELL_SIZES["check_queries"]
    for variant in ("stage1", "base", "opt"):
        t0 = time.perf_counter()
        c = C.build_retriever_cell("colpali", shape, dev, variant, gen)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        gb = C.arg_bytes(c) / 1e9
        ms, times, (sc, ids) = cell_run(c, CELL_SIZES["timed"], launched)
        store, q, qm = c.args
        check(tuple(ids.shape) == (full.query_batch, full.top_k)
              and bool(torch.isfinite(sc).all()),
              f"(c) {variant}: ids {tuple(ids.shape)} or scores not finite")
        swaps, cut_ties = compare_search_cell(
            store, C.search_stages(shape, variant), q[:nq], qm[:nq],
            ids[:nq].cpu().numpy(), sc[:nq].float().cpu().numpy(),
            f"(c) search {variant}")
        qps = full.query_batch / (ms / 1e3)
        out[variant] = dict(ms=ms, qps=qps, gb=gb, swaps=swaps,
                            cut_ties=cut_ties,
                            tflops=c.model_flops / (ms / 1e3) / 1e12)
        log(f"[cells] (c) colpali search_1m {variant} ({c.note}) over {n} "
            f"pages, {gb:.2f} GB of arguments made on the card in "
            f"{t_build:.1f}s: " + cell_line(c, ms, times)
            + f", {qps:.1f} QPS (64 queries a call); queries 0-{nq - 1} "
            f"equal the plain path ({swaps} tie swaps, {cut_ties} explained "
            "by prefetch cut-off ties; scores rtol 1e-5, atol 1e-4)")
        del c, store, q, qm, sc, ids
        gc.collect()
        torch.cuda.empty_cache()
    return out


def cells_lm(dev, gen, launched: dict) -> dict:
    """(d) LM cells at batch 1 (the cut printed): minicpm-2b ``train_4k``,
    gemma3-4b ``prefill_32k`` and ``decode_32k``; a cell whose arguments
    do not fit the free memory even at batch 1 is printed as not run."""
    from repro_torch.configs import get_config
    from repro_torch.launch import cells as C
    out = {}
    for arch, name in (("minicpm-2b", "train_4k"),
                       ("gemma3-4b", "prefill_32k"),
                       ("gemma3-4b", "decode_32k")):
        full = get_shape(arch, name)
        b = CELL_SIZES["lm_batch"]
        shape = dataclasses.replace(full, dims={**full.dims,
                                                "global_batch": b})
        gb = C.arg_bytes(C.build_lm_cell(arch, shape, "meta")) / 1e9
        full_gb = C.arg_bytes(C.build_cell(arch, name, "meta")) / 1e9
        free = torch.cuda.mem_get_info()[0] / 1e9
        cut = (f"reduced: global_batch {full.global_batch} -> {b} "
               f"({full_gb:.2f} -> {gb:.2f} GB of arguments)")
        if gb > free:
            out[f"{arch} {name}"] = None
            log(f"[cells] (d) {arch} {name}: not run: {gb:.2f} GB of "
                f"arguments at batch {b}, {free:.2f} GB free; {cut}")
            continue
        torch.cuda.reset_peak_memory_stats()
        c = C.build_lm_cell(arch, shape, dev, generator=gen)
        ms, times, res = cell_run(c, CELL_SIZES["timed"], launched)
        peak = torch.cuda.max_memory_allocated() / 1e9
        vals = list(res.values()) if isinstance(res, dict) else [res[0]]
        check(all(bool(torch.isfinite(v.float()).all()) for v in vals),
              f"(d) {arch} {name}: non-finite output")
        extra = ""
        if full.kind == "train":
            f, _ = lm_step_flops(get_config(arch), b, full.seq_len)
            extra = (f"; lm_step_flops (8 N T, with the remat forward) "
                     f"{f:.4e} = {f / (ms / 1e3) / 1e12:.2f} TFLOP/s")
        out[f"{arch} {name}"] = dict(
            ms=ms, tflops=c.model_flops / (ms / 1e3) / 1e12, peak_gb=peak)
        log(f"[cells] (d) {arch} {name} ({cut}): " + cell_line(c, ms, times)
            + f" (model_flops: {'6' if full.kind == 'train' else '2'} N "
            f"{'T' if full.kind != 'decode' else 'B'}){extra}; peak "
            f"{peak:.2f} GB")
        del c, res, vals
        gc.collect()
        torch.cuda.empty_cache()
    return out


def cells_path(args, dev, rs: dict, gn: dict) -> dict:
    """Phase 4o: ``launch/cells.py``'s cells, (a) all on ``meta``, (b) the
    full-shape cells that fit (retriever ``index_1m``, dcn-v2, molecule),
    (c) colpali ``search_1m`` at a reduced corpus held to the plain path,
    (d) LM cells at batch 1."""
    from repro_torch.kernels import dispatch as DSP
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[cells] device memory held by earlier phases: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; {free / 1e9:.2f} of "
        f"{total / 1e9:.2f} GB free")
    t0 = time.perf_counter()
    DSP.reset_counts()
    launched = dict.fromkeys(DSP.KERNELS, 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    res = {"a": cells_meta(total)}
    res["index"] = cells_index(dev, gen, launched)
    res["b"] = cells_recsys_gnn(dev, gen, launched, rs, gn)
    res["c"] = cells_search(dev, gen, launched)
    res["d"] = cells_lm(dev, gen, launched)
    res["counts"] = launched
    log(f"[cells] kernel launches of the cells' own calls: "
        f"{ {k: v for k, v in launched.items() if v} }")
    check(launched["pooling"] > 0, "4o launched no pool kernel")
    check(launched["maxsim_scan"] > 0, "4o launched no scan kernel")
    check(launched["maxsim_rerank"] > 0, "4o launched no rerank kernel")
    check(launched["maxsim_scan_int8"] + launched["maxsim_scan_db"] > 0,
          "4o launched no int8 scan or db scan kernel")
    res["seconds"] = time.perf_counter() - t0
    log(f"[cells] phase 4o took {res['seconds']:.1f}s")
    return res


def cells_summary(ce: dict) -> str:
    """Phase 4o's ``[summary]`` line."""
    idx = "; ".join(f"{a} index {r['ms']:.1f} ms ({r['pages_s']:.0f} "
                    f"pages/s, pool err {r['err']:.1e})"
                    for a, r in ce["index"].items())
    b = "; ".join(f"{k} {r['ms']:.3f} ms (then {r['was']:.3f})"
                  + (f", int64 ids {r['int64_ms']:.3f}, int32 again "
                     f"{r['int32_ms']:.3f}" if "int64_ms" in r else "")
                  for k, r in ce["b"].items())
    c = "; ".join(f"{v} {r['ms']:.1f} ms {r['qps']:.1f} QPS"
                  for v, r in ce["c"].items())
    d = "; ".join(f"{k} " + ("not run" if r is None else
                              f"{r['ms']:.1f} ms {r['tflops']:.2f} TFLOP/s")
                  for k, r in ce["d"].items())
    return (f"[summary] cells (a) {len(ce['a']['rows'])} on meta "
            f"({ce['a']['n_over']} over the card); (b) {idx}; {b}; (c) "
            f"colpali search_1m at {CELL_SIZES['corpus']} pages: {c}; (d) "
            f"batch 1: {d}; phase 4o {ce['seconds']:.1f}s")


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 4q. the sharded model bodies (shard_map on one card)
# ---------------------------------------------------------------------------

SHARD_SIZES = dict(gnn_timed=1, moe_batch=(4, 256), moe_timed=2,
                   dlrm_batch=65536, n_cand=1_000_000, timed=3)


def shard_meshes(shape: tuple, axes: tuple) -> tuple:
    """(the card's mesh, the CPU's) of ``shape``: 4 positions on
    ``cuda:0``, and 4 on the CPU."""
    from repro_torch.launch.mesh import make_mesh
    n = int(np.prod(shape))
    return (make_mesh(shape, axes, devices=["cuda:0"] * n),
            make_mesh(shape, axes, devices=["cpu"] * n))


def mixed_mesh(shape: tuple, axes: tuple):
    """A mesh of ``shape`` whose positions alternate between ``cuda:0``
    and the CPU: positions on another device than the model's, as on a
    mesh of separate cards."""
    from repro_torch.launch.mesh import make_mesh
    n = int(np.prod(shape))
    return make_mesh(shape, axes, devices=["cuda:0", "cpu"] * (n // 2))


def same_bits(got, want, what: str) -> None:
    got = got.detach().cpu()
    want = want.detach().cpu()
    check(got.dtype == want.dtype and got.shape == want.shape
          and bool(torch.equal(got, want)),
          f"{what}: the card's result != the CPU mesh's bit for bit "
          f"(max abs err {float((got.double() - want.double()).abs().max()):.3e})")


def close(got, want, rtol: float, atol: float, what: str) -> float:
    got, want = got.detach().cpu(), want.detach().cpu()
    try:
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    except AssertionError as e:
        fail(f"{what}: card != CPU (rtol {rtol}, atol {atol}): {e}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def cos_weight(shape) -> torch.Tensor:
    n = int(np.prod(shape))
    return torch.cos(torch.arange(n, dtype=torch.float32) * 0.7 + 0.3
                     ).reshape(shape)


def shard_collectives(args) -> dict:
    """(a) bodies of elementwise work around every collective on a (2, 2)
    mesh: the card's values and input gradients equal the CPU mesh's bit
    for bit (sums in mesh order; the weighted-sum cotangent is exact)."""
    from repro_torch.distributed import shard_map as SM
    P, BOTH = SM.P, ("data", "model")

    def remat(b):
        return SM.checkpoint(lambda z: SM.all_to_all(
            z * z, BOTH, 0, 0, tiled=True) * z, b)
    cases = {
        "psum over data": (P(BOTH), P(BOTH), lambda b: SM.psum(
            b * b, "data") * (1 + SM.axis_index("model"))),
        "psum over both": (P(BOTH), P(BOTH), lambda b: SM.psum(b * b, BOTH)),
        "all_gather tiled": (P(BOTH), P(BOTH), lambda b: SM.all_gather(
            b, "model", axis=0, tiled=True) * (1 + SM.axis_index(BOTH))),
        "all_gather stacked": (P(BOTH), P(BOTH), lambda b: SM.all_gather(
            b * b, BOTH, axis=0)),
        "all_to_all rows": (P(BOTH), P(BOTH), lambda b: SM.all_to_all(
            b * (1 + SM.axis_index(BOTH)), BOTH, 0, 0, tiled=True)),
        "all_to_all cols": (P("data", "model"), P("data", "model"),
                            lambda b: SM.all_to_all(b * b, "model", 1, 0,
                                                    tiled=True)),
        "checkpoint replay": (P(BOTH), P(BOTH), remat),
        "unreduced under P()": (P(BOTH), P(), lambda b: b * b),
    }
    meshes = shard_meshes((2, 2), BOTH)
    x0 = torch.randn((16, 8), generator=torch.Generator().manual_seed(
        args.seed))
    for name, (ins, outs, body) in cases.items():
        got = []
        for mesh in meshes:
            x = x0.to(mesh.devices.flat[0]).clone().requires_grad_(True)
            y = SM.shard_map(body, mesh, ins, outs)(x)
            (y * cos_weight(tuple(y.shape)).to(y.device)).sum().backward()
            got.append((y, x.grad))
        same_bits(got[0][0], got[1][0], f"(a) {name} value")
        same_bits(got[0][1], got[1][1], f"(a) {name} gradient")
    log(f"[shard] (a) {len(cases)} bodies on (2, 2) (psum over one and both "
        "axes, all_gather tiled and stacked, all_to_all over rows and "
        "columns, a checkpointed all_to_all replayed in the backward, an "
        "unreduced value under P()): values and gradients on "
        "[\"cuda:0\"] * 4 == [\"cpu\"] * 4 bit for bit")
    return dict(n=len(cases))


def gnn_sharded_batch(src, dst, n: int, S: int, cap: int, f: int, n_cls: int,
                      gen, lead: int = 0) -> dict:
    """Node arrays and ``partition_edges``' buckets of one graph at S
    shards, on the host; ``lead`` > 0 stacks that many copies as the
    minibatch cell's dp subgraphs."""
    from repro_torch.models.gnn.graph import partition_edges
    part = partition_edges(src, dst, n, S, cap=cap)
    b = {"feat": torch.randn((n, f), generator=gen),
         "pos": torch.rand((n, 3), generator=gen) * 4 - 2,
         "labels": torch.randint(0, n_cls, (n,), generator=gen),
         "lmask": torch.rand((n,), generator=gen) > 0.1,
         **{k: torch.from_numpy(part[k]) for k in (
             "esrc", "edstg", "emask", "rdst", "rsrcg", "rmask")}}
    if lead:
        b = {k: v.expand((lead,) + tuple(v.shape)).contiguous()
             for k, v in b.items()}
    return b, part["dropped"]


def gnn_losses(cfg, S_vc: int, n: int, tp: int):
    """(vertex-cut loss over (2, 2), minibatch loss at dp = tp = 2) for a
    mesh: ``launch/cells.py``'s bodies."""
    from repro_torch.launch import cells as TC
    return (lambda mesh: TC.vertex_cut_loss(cfg, mesh, n // S_vc,
                                            ("data", "model")),
            lambda mesh: TC.minibatch_loss(cfg, mesh, n // tp, ("data",),
                                           ("model",)))


def shard_gnn(args, dev) -> dict:
    """(b) EquiformerV2's vertex cut at S = 4 and minibatch cell at dp = tp
    = 2: at the CPU tests' size in f32 (remat on), loss and every gradient
    on the card, and on a mesh alternating the card and the CPU (the
    model on the card), against the CPU mesh; at full width (bf16
    messages) on ``full_graph_sm``'s graph, 1 warm-up and
    ``SHARD_SIZES["gnn_timed"]`` timed train steps each."""
    import copy
    from repro_torch.distributed import shard_map as SM
    from repro_torch.models.gnn import equiformer_v2 as E
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train_loop import make_train_step

    res = {}
    gen = torch.Generator().manual_seed(args.seed)
    card, cpu = shard_meshes((2, 2), ("data", "model"))
    # reduced, f32: card vs CPU
    cfg = gnn_reduced(remat=True)
    n, e, f = 64, 256, 10
    src = torch.randint(0, n, (e,), generator=gen).numpy()
    dst = torch.randint(0, n, (e,), generator=gen).numpy()
    vc_loss, mb_loss = gnn_losses(cfg, 4, n, 2)
    b_vc, drop_vc = gnn_sharded_batch(src, dst, n, 4, None, f, 5, gen)
    b_mb, drop_mb = gnn_sharded_batch(src, dst, n, 2, None, f, 5, gen, 2)
    check(drop_vc == drop_mb == 0, "(b) the reduced graph dropped edges")
    ref = E.init_params(cfg, f, 5, torch.Generator().manual_seed(args.seed),
                        "cpu")
    worst = {}
    mixed = mixed_mesh((2, 2), ("data", "model"))
    for name, make, b in (("vertex cut S=4", vc_loss, b_vc),
                          ("minibatch dp=tp=2", mb_loss, b_mb)):
        out = []
        for mesh in (cpu, card, mixed):
            d = mesh.devices.flat[0]
            m = copy.deepcopy(ref).to(d)
            loss = make(mesh)(m, {k: v.to(d) for k, v in b.items()})
            loss.backward()
            out.append((loss.item(), {k: p.grad for k, p in
                                      m.named_parameters()}))
        (lc, gc) = out[0]
        for (lg, gg), where in zip(out[1:], ("card", "card + CPU")):
            check(np.isfinite(lg) and abs(lg - lc) <= 1e-5 * abs(lc),
                  f"(b) {name}: {where} loss {lg!r} != CPU {lc!r} "
                  "(rtol 1e-5)")
            err = max(close(gg[k], gc[k], 1e-3, 1e-6,
                            f"(b) {name} {where} grad {k}") for k in gc)
            worst[f"{name} {where}"] = err
            log(f"[shard] (b) {name} on {where} "
                f"{[str(x) for x in (card if where == 'card' else mixed).devices.flat]}, "
                f"the CPU tests' size (2 layers, d 16, f32, remat on), {n} "
                f"nodes, {e} edges: loss {lg:.7f} vs CPU mesh {lc:.7f} "
                f"(rtol 1e-5); {len(gc)} grad tensors within rtol 1e-3, "
                f"atol 1e-6, max abs err {err:.2e}")
    # full width, bf16 messages, on full_graph_sm's graph
    cfg = gnn_config("base")
    n, e, f, n_cls = 2708, 10556, 1433, GNN_SIZES["sm_classes"]
    src = torch.randint(0, n, (e,), generator=gen).numpy()
    dst = torch.randint(0, n, (e,), generator=gen).numpy()
    vc_loss, mb_loss = gnn_losses(cfg, 4, n, 2)
    oc = OPT.OptConfig()
    flops, _ = gnn_flops(cfg, e)
    for name, make, S, cap_rule, lead in (
            ("vertex cut S=4", vc_loss, 4, 1.25, 0),
            ("minibatch dp=tp=2", mb_loss, 2, 2.0, 2)):
        cap = max(8, int(np.ceil(e / (S * S) * cap_rule / 8)) * 8)
        b, dropped = gnn_sharded_batch(src, dst, n, S, cap, f, n_cls, gen,
                                       lead)
        b = {k: v.to(dev) for k, v in b.items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = E.init_params(cfg, f, n_cls, torch.Generator(
            device=dev).manual_seed(args.seed), dev)
        params = dict(model.named_parameters())
        labels = OPT.default_labels(params)
        opt = OPT.init_opt_state(params, labels)
        loss_fn = make(card)
        step = make_train_step(loss_fn, oc, labels=labels)
        SM.TRAFFIC.update(all_to_all=0, psum=0)
        with torch.no_grad():
            loss_fn(model, b)
        a2a = SM.TRAFFIC["all_to_all"]
        times, losses = [], []
        for i in range(1 + SHARD_SIZES["gnn_timed"]):
            m, ms = event_ms(lambda: step(model, opt, b))
            losses.append(float(m["loss"]))
            if i:
                times.append(ms)
        check(all(np.isfinite(losses)), f"(b) {name} full width: non-finite "
              f"loss {losses}")
        ms = statistics.median(times)
        mult = lead or 1
        res[name] = dict(ms=ms, peak_gb=torch.cuda.max_memory_allocated()
                         / 1e9, a2a_layer_mb=a2a / cfg.n_layers / 1e6,
                         cap=cap, dropped=dropped, losses=losses)
        log(f"[shard] (b) {name}, full width ({sum(p.numel() for p in params.values()) / 1e6:.2f}M "
            f"params, bf16 messages, remat on), full_graph_sm's graph "
            f"({n} nodes, {e} edges{', one copy per dp position' if lead else ''}), cap "
            f"{cap}, {dropped} edges dropped: {ms:.1f} ms/step (median of "
            f"{len(times)}, CUDA events; {mult * flops / ms / 1e9:.2f} TFLOP/s "
            f"by cells.py's _gnn_flops), peak {res[name]['peak_gb']:.2f} GB, "
            f"all_to_all {res[name]['a2a_layer_mb']:.2f} MB a layer between "
            f"positions (forward), losses {losses}")
        del model, opt, step, b, params
    res["worst"] = worst
    return res


def shard_moe(args, dev, lm) -> dict:
    """(c) granite-moe-1b-a400m at full width with ``ragged_ep`` over tp =
    4: 2 layers in f32 at 4l (d)'s batch, layer 0's router skewed so that
    pairs are dropped, on the card against the CPU mesh (loss, every
    gradient, the assignments kept and dropped); all 24
    layers in f32 at that batch: a train step timed beside 4l (d)'s
    one-device ragged step, the share of dropped assignments, and the
    loss against ``moe_ragged``'s."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch import train as TR
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train_loop import make_train_step

    base = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                               dtype="float32")
    ep = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, impl="ragged_ep"))
    card, cpu = shard_meshes((1, 4), ("data", "model"))
    two = dataclasses.replace(ep, n_layers=2)
    ref = T.init_params(two, torch.Generator().manual_seed(args.seed), "cpu")
    # a skewed router, as the CPU tests use: every token's residual stream
    # leans along u and layer 0's expert 0 reads u, so that expert's owner
    # fills past capacity and the comparison covers the dropped pairs
    u = torch.randn((two.d_model,), generator=torch.Generator().manual_seed(
        args.seed + 1))
    with torch.no_grad():
        ref.embed += 3.0 * u / u.norm()
        ref.layers[0].ffn["router"][:, 0] = 8.0 * u / u.norm()
    B, S = SHARD_SIZES["moe_batch"]
    b = TR.make_batch(two, args.seed, 0, B, S, "cpu")
    out = []
    for mesh in (cpu, card):
        d = mesh.devices.flat[0]
        m = copy.deepcopy(ref).to(d)
        L.EP_STATS.update(assigned=0, kept=0)
        loss = T.loss_fn(m, {k: v.to(d) for k, v in b.items()},
                         ShardingPolicy(mesh))
        counts = dict(L.EP_STATS)
        loss.backward()
        out.append((loss.item(), {k: p.grad for k, p in
                                  m.named_parameters()}, counts))
    (lc, gc, nc), (lg, gg, ng) = out
    check(np.isfinite(lg) and abs(lg - lc) <= 1e-5 * abs(lc),
          f"(c) 2 layers: card loss {lg!r} != CPU mesh {lc!r} (rtol 1e-5)")
    check(ng == nc, f"(c) 2 layers: the card kept {ng}, the CPU mesh {nc}")
    check(ng["kept"] < ng["assigned"], "(c) 2 layers: nothing was dropped, "
          "so the capacity path went unchecked")
    worst = max(close(gg[k], gc[k], 1e-3, 1e-6, f"(c) grad {k}") for k in gc)
    drop2 = 1 - ng["kept"] / ng["assigned"]
    log(f"[shard] (c) {base.name} ragged_ep over tp=4, 2 layers at full "
        f"width (d {base.d_model}, {base.moe.n_experts} experts top "
        f"{base.moe.top_k}), f32, batch {B} x {S}: loss {lg:.7f} vs CPU mesh "
        f"{lc:.7f} (rtol 1e-5); {len(gc)} grad tensors within rtol 1e-3, "
        f"atol 1e-6, max abs err {worst:.2e}; {ng['assigned'] - ng['kept']} "
        f"of {ng['assigned']} owned assignments dropped past capacity "
        f"({100 * drop2:.3f}%; layer 0's router skewed), the same on both")
    del ref, out, gc, gg
    # all 24 layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = T.init_params(ep, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    B, S = SHARD_SIZES["moe_batch"]
    b = TR.make_batch(ep, args.seed, 0, B, S, dev)
    pol = ShardingPolicy(card)
    L.EP_STATS.update(assigned=0, kept=0)
    with torch.no_grad():
        loss_ep = float(T.loss_fn(model, b, pol))
        kept, assigned = L.EP_STATS["kept"], L.EP_STATS["assigned"]
        model.cfg = dataclasses.replace(ep, moe=dataclasses.replace(
            ep.moe, impl="ragged"))
        loss_rg = float(T.loss_fn(model, b))
        model.cfg = ep
    dropped = 1 - kept / assigned
    rel = abs(loss_ep - loss_rg) / abs(loss_rg)
    check(np.isfinite(loss_ep), "(c) full width: non-finite loss")
    if kept == assigned:
        check(rel <= 1e-5, f"(c) nothing dropped, yet the ragged_ep loss "
              f"{loss_ep!r} != moe_ragged's {loss_rg!r} (rtol 1e-5)")
    params = dict(model.named_parameters())
    labels = OPT.default_labels(params)
    opt = OPT.init_opt_state(params, labels)
    oc = OPT.OptConfig(lr=3e-4, warmup=10, total_steps=50)
    step = make_train_step(lambda m, bb: T.loss_fn(m, bb, pol), oc,
                           labels=labels)
    times = []
    for i in range(1 + SHARD_SIZES["moe_timed"]):
        mt, ms = event_ms(lambda: step(model, opt, b))
        check(np.isfinite(float(mt["loss"])), "(c) non-finite train loss")
        if i:
            times.append(ms)
    ms = statistics.median(times)
    one = lm["d"]["ragged_ms"]
    log(f"[shard] (c) {base.name}, {base.n_layers} layers, f32, batch {B} x "
        f"{S}, ragged_ep over (1, 4) on one card: {ms:.1f} ms/step (median "
        f"of {len(times)}; 4l (d)'s one-device ragged step {one:.1f} ms, "
        f"ratio {ms / one:.2f}); {assigned - kept} of {assigned} owned "
        f"assignments dropped past capacity ({100 * dropped:.3f}%); loss "
        f"{loss_ep:.7f} vs moe_ragged {loss_rg:.7f} (rel err {rel:.2e}"
        + (", rtol 1e-5 held: none dropped)" if kept == assigned else
           ", not held to 1e-5: some were dropped)")
        + f"; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del model, opt, step, params
    return dict(ms=ms, one_ms=one, dropped=dropped, loss_rel=rel,
                grad_abs=worst, dropped_2l=drop2)


def shard_dlrm(args, dev) -> dict:
    """(d) dlrm-mlperf's capped table row-sharded over 4 positions:
    ``lookup_shardmap`` against ``lookup`` bit for bit at batch 65536."""
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.models.recsys import embedding as EMB
    from repro_torch.models.recsys import nets as R

    cfg = recsys_config("dlrm-mlperf")
    card, _ = shard_meshes((1, 4), ("data", "model"))
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    layout = R.layout_of(cfg)
    check(bool(layout.big_fields), "(d) dlrm-mlperf has no row-sharded field")
    emb = EMB.init_embedding(layout, gen, dev, n_shards=4)
    idx = recsys_batch(cfg, SHARD_SIZES["dlrm_batch"], dev, gen,
                       "query")["sparse"]
    pol = ShardingPolicy(card)
    with torch.no_grad():
        whole = EMB.lookup(emb, idx)
        sharded = EMB.lookup_shardmap(emb, idx, pol)
        check(bool(torch.equal(whole, sharded)), "(d) lookup_shardmap != "
              "lookup bit for bit")
        t_one = time_ms(lambda: EMB.lookup(emb, idx), iters=3)
        t_sh = time_ms(lambda: EMB.lookup_shardmap(emb, idx, pol), iters=3)
    gb = sum(t.numel() * t.element_size() for t in emb.parameters()) / 1e9
    log(f"[shard] (d) dlrm-mlperf, {len(cfg.vocab_sizes)} fields capped at "
        f"{RECSYS_ROW_CAP} rows ({gb:.2f} GB; big table "
        f"{tuple(emb.big.shape)} over 4 row slabs), batch "
        f"{SHARD_SIZES['dlrm_batch']}: lookup_shardmap == lookup bit for "
        f"bit; {t_sh:.3f} ms sharded vs {t_one:.3f} ms whole (median of 3, "
        "CUDA events)")
    del emb, whole, sharded
    return dict(ms=t_sh, one_ms=t_one)


def shard_retrieval(args, dev) -> dict:
    """(e) dcn-v2's 2-stage candidate search over 10^6 candidates with the
    two-level top-k at S = 4 against the one-level search."""
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.models.recsys import nets as R

    cfg = recsys_config("dcn-v2")
    card, _ = shard_meshes((2, 2), ("data", "model"))
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = R.init_params(cfg, gen, dev)
    N = SHARD_SIZES["n_cand"]
    q = recsys_batch(cfg, 1, dev, gen, "query")
    batch = dict(q, candidates=torch.randint(
        0, cfg.vocab_sizes[R._item_field(cfg)], (N,), generator=gen,
        device=dev))
    pol = ShardingPolicy(card)
    res = {}
    for name, kw in (("one-level", {}), ("two-level S=4", dict(
            two_level_topk=True, shard=pol))):
        R.retrieval_step(cfg, model, batch, stages=2, **kw)
        times = []
        for _ in range(SHARD_SIZES["timed"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, i = R.retrieval_step(cfg, model, batch, stages=2, **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        res[name] = dict(ms=statistics.median(times), ids=i, scores=s)
    a, b2 = res["one-level"], res["two-level S=4"]
    sw = 0
    for j in np.flatnonzero((a["ids"] != b2["ids"]).cpu().numpy()):
        sc = a["scores"].cpu().numpy()
        near = [abs(sc[j] - sc[jj]) <= 1e-5 for jj in (j - 1, j + 1)
                if 0 <= jj < len(sc)]
        check(any(near), f"(e) two-level id at rank {j} differs without a "
              "tie within 1e-5")
        sw += 1
    log(f"[shard] (e) dcn-v2 2-stage (256 -> 100) over {N} candidates: "
        f"two-level top-k at S=4 ids == one-level ids ({sw} differ at ties "
        f"within 1e-5); {b2['ms']:.2f} ms vs {a['ms']:.2f} ms one-level "
        "(median of 3, host clock)")
    del model
    return dict(ms=b2["ms"], one_ms=a["ms"], swaps=sw)


def shard_compressed(args, dev) -> dict:
    """(f) ``psum_compressed`` on a dp = 4 mesh over one full-width
    gradient tree (EquiformerV2's, 107.66M params a position), timed on
    the card: its averages and residuals of every leaf kind (the leaves
    outside the layers and those of layer 0; each leaf is compressed on
    its own) equal the CPU mesh's bit for bit."""
    from repro_torch.distributed import shard_map as SM
    from repro_torch.models.gnn import equiformer_v2 as E
    from repro_torch.training import compression as C

    with torch.device("meta"):
        shapes = {k: tuple(p.shape) for k, p in E.init_params(
            gnn_config("base"), 1433, 47, None, "meta").named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    g = {k: torch.randn((4,) + s, generator=gen, device=dev) for k, s in
         shapes.items()}
    r = {k: torch.randn((4,) + s, generator=gen, device=dev) * 1e-3
         for k, s in shapes.items()}
    keys = list(shapes)
    kinds = [k for k in keys if not k.startswith("layers.")
             or k.startswith("layers.0.")]

    def body(g, r):
        avg, rs = C.psum_compressed({k: v[0] for k, v in g.items()},
                                    {k: v[0] for k, v in r.items()}, "data")
        return ({k: v[None] for k, v in avg.items()},
                {k: v[None] for k, v in rs.items()})
    card, cpu = shard_meshes((4,), ("data",))
    spec = (SM.P("data"), SM.P("data"))
    f = SM.shard_map(body, card, spec, SM.P("data"))
    f(g, r)
    times = []
    for _ in range(SHARD_SIZES["timed"]):
        (avg_g, rs_g), t = event_ms(lambda: f(g, r))
        times.append(t)
    ms = statistics.median(times)
    avg_c, rs_c = SM.shard_map(body, cpu, spec, SM.P("data"))(
        {k: g[k].cpu() for k in kinds}, {k: r[k].cpu() for k in kinds})
    del g, r
    for k in kinds:
        same_bits(avg_g[k], avg_c[k], f"(f) average {k}")
        same_bits(rs_g[k], rs_c[k], f"(f) residual {k}")
    n = sum(int(np.prod(s)) for s in shapes.values())
    gb = 4 * n * 4 / 1e9
    log(f"[shard] (f) psum_compressed over (4,) (dp = 4), EquiformerV2's "
        f"gradient tree ({len(keys)} leaves, {n / 1e6:.2f}M params a "
        f"position, f32): averages and residuals of the {len(kinds)} leaves "
        f"outside the layers and of layer 0 == the CPU mesh's bit for "
        f"bit; {ms:.2f} ms a call (median of 3, CUDA events), {gb / ms * 1e3:.1f} "
        f"GB/s of the 4 positions' f32 gradients ({gb:.3f} GB)")
    return dict(ms=ms, gbs=gb / ms * 1e3)


def shard_specs(args, dev) -> dict:
    """(g) granite-moe's ``param_specs`` resolved at (2, 2) on its 2-layer
    full-width leaves, the state resharded onto (1, 4) with
    ``reshard_tree`` (by the specs at tp = 4, dp = 1) and a checkpoint of
    it restored with ``shardings=``: every slab equals its slice of the
    whole leaf bit for bit."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import elastic as EL

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"), n_layers=2)
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    names = model.jax_leaf_names()
    leaves = model.to_jax_leaves()
    del model
    m22, _ = shard_meshes((2, 2), ("data", "model"))
    m14, _ = shard_meshes((1, 4), ("data", "model"))
    specs = [T._tree_get(T.param_specs(cfg, 2, 2), n) for n in names]
    # the new topology's own specs (tp = 4, dp = 1), as an elastic restart
    # re-resolves them
    specs14 = [T._tree_get(T.param_specs(cfg, 4, 1), n) for n in names]
    pol = SH.ShardingPolicy(m22)

    def held(placed, what):
        split = 0
        for name, leaf, sh in zip(names, leaves, placed):
            mesh, spec = sh.sharding.mesh, sh.sharding.spec
            split += any(e is not None for e in spec)
            for c, slab in zip(SH.mesh_coords(mesh), sh.slabs):
                check(bool(torch.equal(slab, SH.block(leaf, mesh, spec, c))),
                      f"(g) {what} {name}: a slab != its slice")
        return split
    placed = [SH.device_put(x, pol.named(*s)) for x, s in zip(leaves, specs)]
    n22 = held(placed, "(2, 2)")
    moved = EL.reshard_tree(placed, specs14, m14)
    n14 = held(moved, "resharded onto (1, 4)")
    d = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        CK.save(d, 1, leaves, leaf_names=names)
        pol14 = SH.ShardingPolicy(m14)
        got, _ = CK.restore(d, shardings=[pol14.named(*s) for s in specs14])
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    held(got, "restored onto (1, 4)")
    gb = sum(x.numel() * x.element_size() for x in leaves) / 1e9
    log(f"[shard] (g) {cfg.name} at 2 layers, full width ({len(names)} "
        f"leaves, {gb:.3f} GB): param_specs at (2, 2) split {n22} leaves "
        f"over the mesh, resharded onto (1, 4) {n14}; a checkpoint saved "
        f"and restored with shardings= in {secs:.2f} s; every slab of the "
        "three == its slice of the whole leaf bit for bit")
    return dict(split22=n22, split14=n14)


def shard_path(args, dev, lm) -> dict:
    """Phase 4q: the sharded model bodies on one card (4 positions on
    ``cuda:0``) against the CPU mesh, then at full width."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    res = {"a": shard_collectives(args)}
    res["b"] = shard_gnn(args, dev)
    res["c"] = shard_moe(args, dev, lm)
    res["d"] = shard_dlrm(args, dev)
    res["e"] = shard_retrieval(args, dev)
    res["f"] = shard_compressed(args, dev)
    res["g"] = shard_specs(args, dev)
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    log(f"[shard] phase 4q {res['seconds']:.1f}s")
    return res


# ---------------------------------------------------------------------------
# 4r. the partitioned cells (placed slabs, a partitioned train step)
# ---------------------------------------------------------------------------

PART_SIZES = dict(timed=2, lm_layers=16, lm_batch=2, lm_seq=4096,
                  moe_batch=(4, 256), gemma_batch=2, gemma_seq=2048,
                  n_dec=16, colpali_batch=16, index_pages=256, gnn_timed=1,
                  b4r_train=8192, bulk_timed=1, b4r_bulk_chunk=16384)
# bert4rec's partitioned train step at 4m's 16384 peaked at 78.02 GB run
# alone on an NVIDIA H100 80GB HBM3 at 700 W and ran out of memory after
# the earlier phases: autograd numbers each position thread's nodes from
# 0, so the one backward recomputes the positions' checkpointed blocks
# side by side
# the recsys cells' meshes at full width: dlrm-mlperf's capped table in 4
# row slabs (tp = 4, dp = 1), the others 2 slabs and 2 batch halves
PART_RECSYS = {"dcn-v2": (2, 2), "autoint": (2, 2), "bert4rec": (2, 2),
               "dlrm-mlperf": (1, 4)}
# the CPU tests' LM configs (``tests/test_torch_partitioned_lm.py``)
PART_LM = {"minicpm": ("minicpm-2b", {}),
           "gemma3": ("gemma3-4b", {"attn_pattern": (8,) * 5 + (0,)}),
           "zero_seq": ("gemma2-9b", {"n_heads": 3, "n_kv_heads": 1,
                                      "d_ff": 255, "attn_pattern": (8, 0)})}


def part_lm_cfg(name: str):
    from repro_torch.configs import get_config
    from repro_torch.launch import train as TR
    arch, over = PART_LM[name]
    return dataclasses.replace(TR.reduced_lm(get_config(arch)),
                               vocab_size=500, **over)


class patched_config:
    """``launch/cells.py``'s ``get_config`` returning ``cfg`` inside."""

    def __init__(self, cfg):
        self.cfg = cfg

    def __enter__(self):
        from repro_torch.launch import cells as C
        self.old, C.get_config = C.get_config, lambda arch: self.cfg

    def __exit__(self, *exc):
        from repro_torch.launch import cells as C
        C.get_config = self.old


def part_shape(kind: str, **dims):
    from repro_torch.configs import ShapeSpec
    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k", "index": "index_1m",
            "batched_graphs": "molecule",
            "full_graph": "full_graph_sm"}.get(kind, kind)
    return ShapeSpec(name, kind, dims)


def part_step_close(what, card, cpu, lr):
    """(a) a train cell's step on the card against the CPU mesh: loss
    (rtol 1e-5), grad_norm, every moment (0.1 x the clip-scaled
    gradient: rtol 1e-3, atol 1e-7; of a row-wise Adagrad leaf the root
    of its accumulator, each row's mean square gradient: rtol 1e-3, atol
    1e-6) and parameter (rtol 1e-5, atol 2 lr: Adam's first step is a
    sign)."""
    (mg, pg, og), (mc, pc, oc_) = card, cpu
    lg, lc = float(mg["loss"]), float(mc["loss"])
    check(np.isfinite(lg) and abs(lg - lc) <= 1e-5 * abs(lc),
          f"(a) {what}: card loss {lg!r} != CPU mesh {lc!r} (rtol 1e-5)")
    worst = 0.0
    for n in pg:
        sg, sc = og["per_leaf"][n], oc_["per_leaf"][n]
        if "acc" in sg:
            close(sg["acc"].gather().sqrt(), sc["acc"].gather().sqrt(), 1e-3,
                  1e-6, f"(a) {what} row-wise accumulator {n}")
        else:
            worst = max(worst, close(sg["m"].gather(), sc["m"].gather(),
                                     1e-3, 1e-7, f"(a) {what} moment {n}"))
        close(pg[n].gather(), pc[n].gather(), 1e-5, 2 * lr,
              f"(a) {what} parameter {n}")
    return dict(loss_rel=abs(lg - lc) / abs(lc), moment_abs=worst,
                gn=(float(mg["grad_norm"]), float(mc["grad_norm"])))


def part_card_vs_cpu(args) -> dict:
    """(a) each partitioned cell at the CPU tests' sizes in f32 on
    ``["cuda:0"] * 4`` against ``["cpu"] * 4``."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import device_put
    from repro_torch.kernels import pooling as POPS
    from repro_torch.launch import cells as C
    from repro_torch.models.gnn import equiformer_v2 as E

    out = {}
    m22 = shard_meshes((2, 2), ("data", "model"))
    m41 = shard_meshes((4, 1), ("data", "model"))

    def gen():
        return torch.Generator().manual_seed(args.seed)

    def train(what, build, meshes):
        res = []
        for mesh in meshes:
            c = build(mesh)
            m = c.fn(*c.args)
            res.append((m, c.args[0], c.args[1]))
        r = part_step_close(what, res[0], res[1], float(res[1][0]["lr"]))
        log(f"[partitioned] (a) {what}: loss {float(res[0][0]['loss']):.7f}"
            f" vs CPU mesh {float(res[1][0]['loss']):.7f} (rel err "
            f"{r['loss_rel']:.2e}, rtol 1e-5), grad_norm {r['gn'][0]:.7f} "
            f"vs {r['gn'][1]:.7f}; every moment within rtol 1e-3, atol 1e-7"
            f" (max abs err {r['moment_abs']:.2e}), parameters rtol 1e-5")
        return r

    for name in ("minicpm", "zero_seq"):
        cfg = part_lm_cfg(name)
        with patched_config(cfg):
            out[name] = train(
                f"{name} train base on (2, 2), batch 32 x 16",
                lambda mesh: C.build_lm_cell(
                    PART_LM[name][0], part_shape("train", seq_len=16,
                                                 global_batch=32),
                    variant="base", generator=gen(), mesh=mesh), m22)
    # prefill + 4 decode steps (gemma3, windows of 8: the ring wraps),
    # both meshes fed the same tokens
    cfg = part_lm_cfg("gemma3")
    toks = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (4, 4, 1)).astype(np.int32))
    res = []
    with patched_config(cfg):
        for mesh in m22:
            p = C.build_lm_cell("gemma3-4b", part_shape(
                "prefill", seq_len=12, global_batch=4), generator=gen(),
                mesh=mesh)
            logits, caches = p.fn(*p.args)
            d = C.build_lm_cell("gemma3-4b", part_shape(
                "decode", seq_len=12, global_batch=4), generator=gen(),
                mesh=mesh)
            caches = device_put([[{k: v.gather() for k, v in s.items()}
                                  for s in seg] for seg in caches],
                                [[{k: v.sharding for k, v in s.items()}
                                  for s in seg] for seg in d.args[1]],
                                copy=True)
            steps = [logits]
            for i in range(4):
                steps.append(d.fn(d.args[0], caches, device_put(
                    toks[i], d.args[2].sharding, copy=True), device_put(
                    torch.tensor(12 + i, dtype=torch.int32),
                    d.args[3].sharding, copy=True)))
            res.append(steps)
    worst = max(close(g, c, 1e-5, 1e-5, f"(a) gemma3 prefill/decode {i}")
                for i, (g, c) in enumerate(zip(*res)))
    out["decode"] = worst
    log(f"[partitioned] (a) gemma3 reduced (windows of 8) prefill 4 x 12 "
        f"on (2, 2) + 4 decode steps (ring slots 4-7): logits within rtol "
        f"1e-5, atol 1e-5 of the CPU mesh, max abs err {worst:.2e}")
    # molecule, f32 messages
    gcfg = gnn_reduced()
    msg = E._msg_dtype
    E._msg_dtype = lambda c: torch.float32
    try:
        with patched_config(gcfg):
            out["molecule"] = train(
                "molecule on (4, 1), 8 graphs, f32 messages",
                lambda mesh: C.build_gnn_cell(
                    "equiformer-v2", part_shape(
                        "batched_graphs", n_nodes=6, n_edges=12, batch=8,
                        d_feat=4), generator=gen(), mesh=mesh), m41)
            # the small full graph, its 62 edges padded to 64 over flat
            for variant in ("base", "opt"):
                out[f"full_graph_{variant}"] = train(
                    f"full_graph_sm {variant} on (2, 2), 20 nodes, 62 "
                    "edges over flat (padded to 64), f32 messages",
                    lambda mesh: C.build_gnn_cell(
                        "equiformer-v2", part_shape(
                            "full_graph", n_nodes=20, n_edges=62, d_feat=5),
                        variant=variant, generator=gen(), mesh=mesh), m22)
    finally:
        E._msg_dtype = msg
    # colpali train and index (the encoder tests' small config)
    rcfg = dataclasses.replace(
        get_config("colpali"), d_model=64, n_layers=2, n_heads=4, d_ff=128,
        grid_h=8, grid_w=8, n_tiles=3, tile_patches=16, max_rows=8,
        query_vocab=128)
    with patched_config(rcfg):
        out["colpali"] = train(
            "colpali train_contrastive on (4, 1), batch 8",
            lambda mesh: C.build_retriever_cell(
                "colpali", part_shape("train", global_batch=8),
                generator=gen(), mesh=mesh), m41)
        pooled = []
        fused = POPS.pool_pages_fused

        def keep(*a):
            y = fused(*a)
            pooled.append(y.detach().float().cpu())
            return y
        POPS.pool_pages_fused = keep
        try:
            outs = []
            for mesh in m41:
                c = C.build_retriever_cell("colpali", part_shape(
                    "index", pages_per_step=8, corpus=100), generator=gen(),
                    mesh=mesh)
                with torch.inference_mode():
                    outs.append(c.fn(*c.args))
        finally:
            POPS.pool_pages_fused = fused
    check(len(pooled) == 8, f"(a) index: {len(pooled)} pooling calls, want "
          "one per position on each mesh")
    worst = max(close(g, c, 1e-5, 1e-5, f"(a) index pooled, position {i}")
                for i, (g, c) in enumerate(zip(pooled[:4], pooled[4:])))
    vg, vc = outs[0][0].float().cpu(), outs[1][0].float()
    step = float(((vg - vc).abs() / (vc.abs() * 2.0 ** -7 + 1e-6)).max())
    check(step <= 1.0, "(a) index vectors: the card's bf16 vectors are more "
          "than one bf16 step from the CPU mesh's")
    out["index"] = worst
    log(f"[partitioned] (a) colpali index_1m on (4, 1), 8 pages: each "
        f"position's f32 pooled vectors (pool.cu on the card) within rtol "
        f"1e-5, atol 1e-5 of the CPU mesh's, max abs err {worst:.2e}; the "
        f"bf16 vectors within one bf16 step ({step:.2f} of one)")
    return out


def part_state_line(params, opt=None) -> str:
    from repro_torch.distributed import placement as PL
    line = (f"per position params {PL.slab_bytes(params) / 1e9:.3f} GB of "
            f"{PL.whole_bytes(params) / 1e9:.3f} GB whole")
    if opt is not None:
        line += (f", optimizer state {PL.slab_bytes(opt) / 1e9:.3f} of "
                 f"{PL.whole_bytes(opt) / 1e9:.3f} GB")
    return line


def part_traffic_line(steps: int) -> str:
    from repro_torch.distributed import shard_map as SM
    return "bytes between positions a call: " + (", ".join(
        f"{k} {v / steps / 1e6:.1f} MB" for k, v in SM.TRAFFIC.items() if v)
        or "none")


def part_timed(fn, n: int, warm: bool = True) -> tuple:
    """(outputs, ms of the timed calls): one warm-up call (unless not
    ``warm``), then ``n`` calls timed by CUDA events; TRAFFIC counts the
    timed calls."""
    from repro_torch.distributed import shard_map as SM
    outs = [fn()] if warm else []
    torch.cuda.synchronize()
    for k in SM.TRAFFIC:
        SM.TRAFFIC[k] = 0
    times = []
    for _ in range(n):
        o, ms = event_ms(fn)
        outs.append(o)
        times.append(ms)
    return outs, times


def part_train_pair(what, build, schedule, mesh, rtol, n) -> dict:
    """A train cell on one device, then partitioned over ``mesh`` from the
    same generator seed (the same weights and batch): ms per step of
    each, the first step's losses within ``rtol``, every loss finite."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    c = build(None)
    outs, t1 = part_timed(lambda: c.fn(*c.args), n)
    l1 = [float(m["loss"]) for m in outs]
    del c, outs
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c = build(mesh)
    outs, tp = part_timed(lambda: c.fn(*c.args), n)
    lp = [float(m["loss"]) for m in outs]
    lrs = [float(m["lr"]) for m in outs]
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(lp + l1)), f"(b) {what}: non-finite loss")
    gap = abs(lp[0] - l1[0]) / abs(l1[0])
    check(gap <= rtol, f"(b) {what}: partitioned loss {lp[0]!r} vs one "
          f"device {l1[0]!r} (rel gap {gap:.2e} > {rtol})")
    want_lr = [float(x) for x in schedule(torch.arange(
        1, len(lrs) + 1, dtype=torch.int32))]
    check(np.allclose(lrs, want_lr, rtol=1e-6), f"(b) {what}: lr {lrs} "
          f"!= the schedule's {want_lr}")
    ms, one = statistics.median(tp), statistics.median(t1)
    log(f"[partitioned] (b) {what}: {ms:.1f} ms/step (median of {n}; one "
        f"device {one:.1f}, ratio {ms / one:.2f}); first-step loss "
        f"{lp[0]:.6f} vs one device {l1[0]:.6f} (rel gap {gap:.2e}, limit "
        f"{rtol}); losses " + " ".join(f"{x:.5f}" for x in lp)
        + f", lr the schedule's; {part_state_line(c.args[0], c.args[1])}; "
        f"{part_traffic_line(n)}; peak {peak:.2f} GB; "
        f"{time.perf_counter() - t0:.1f}s")
    secs = time.perf_counter() - t0
    del c, outs
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ms=ms, one_ms=one, gap=gap, peak_gb=peak, seconds=secs)


def part_full(args, dev) -> dict:
    """(b) the partitioned cells at full width against the one-device
    cells on the same weights and inputs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch as DSP
    from repro_torch.launch import cells as C
    from repro_torch.training import optimizer as OPT

    card22, _ = shard_meshes((2, 2), ("data", "model"))
    card14, _ = shard_meshes((1, 4), ("data", "model"))
    card41, _ = shard_meshes((4, 1), ("data", "model"))
    n = PART_SIZES["timed"]
    out = {}

    def gen():
        return torch.Generator(device=dev).manual_seed(args.seed)

    cosine = OPT.make_schedule(OPT.OptConfig())

    # minicpm-2b train_4k base on (2, 2), one sequence per dp position
    cfg = dataclasses.replace(get_config("minicpm-2b"),
                              n_layers=PART_SIZES["lm_layers"])
    shape = part_shape("train", seq_len=PART_SIZES["lm_seq"],
                       global_batch=PART_SIZES["lm_batch"])
    with patched_config(cfg):
        out["minicpm"] = part_train_pair(
            f"minicpm-2b train_4k base, {cfg.n_layers} of 40 layers, batch "
            f"{shape.global_batch} x {shape.seq_len}, bf16, on (2, 2)",
            lambda mesh: C.build_lm_cell("minicpm-2b", shape, dev,
                                         generator=gen(), mesh=mesh),
            OPT.make_schedule(OPT.OptConfig(schedule="wsd")), card22, 2e-3,
            n)
    # granite-moe base (moe_dense, experts over tp = 4), f32, 4l (d)'s batch
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              dtype="float32")
    B, S = PART_SIZES["moe_batch"]
    shape = part_shape("train", seq_len=S, global_batch=B)
    with patched_config(cfg):
        out["granite"] = part_train_pair(
            f"granite-moe-1b-a400m train base (moe_dense, experts over tp "
            f"= 4), f32, batch {B} x {S}, on (1, 4)",
            lambda mesh: C.build_lm_cell("granite-moe-1b-a400m", shape, dev,
                                         generator=gen(), mesh=mesh),
            cosine, card14, 1e-5, n)
    # colpali train_contrastive on (4, 1) at batch 16
    shape = part_shape("train", global_batch=PART_SIZES["colpali_batch"])
    out["colpali"] = part_train_pair(
        f"colpali train_contrastive ({get_config('colpali').n_layers} "
        f"layers, f32), batch "
        f"{shape.global_batch}, on (4, 1)",
        lambda mesh: C.build_retriever_cell("colpali", shape, dev,
                                            generator=gen(), mesh=mesh),
        cosine, card41, 1e-4, n)
    # molecule at its full shape on (4, 1)
    shape = get_shape("equiformer-v2", "molecule")
    out["molecule"] = part_train_pair(
        f"equiformer-v2 molecule ({shape.batch} graphs of "
        f"{shape.n_nodes} nodes, bf16 messages) on (4, 1)",
        lambda mesh: C.build_gnn_cell("equiformer-v2", shape, dev,
                                      generator=gen(), mesh=mesh),
        cosine, card41, 2.0 ** -8, n)
    # full_graph_sm at its full shape on (2, 2): edges over flat
    shape = get_shape("equiformer-v2", "full_graph_sm")
    for variant in ("base", "opt"):
        out[f"full_graph_{variant}"] = part_train_pair(
            f"equiformer-v2 full_graph_sm {variant} ({shape.n_nodes} nodes, "
            f"{shape.n_edges} edges over flat, {shape.d_feat} features, "
            "bf16 messages) on (2, 2)",
            lambda mesh: C.build_gnn_cell("equiformer-v2", shape, dev,
                                          variant, generator=gen(),
                                          mesh=mesh),
            cosine, card22, 2.0 ** -8, PART_SIZES["gnn_timed"])
    out["gemma3"] = part_gemma(args, dev, card14, card22)
    # colpali index_1m on (4, 1): pool.cu on every position
    torch.cuda.empty_cache()
    shape = part_shape("index", pages_per_step=PART_SIZES["index_pages"],
                       corpus=1_000_000)
    one = C.build_retriever_cell("colpali", shape, dev, generator=gen())
    with torch.inference_mode():
        o1, t1 = part_timed(lambda: one.fn(*one.args), n)
    del one
    c = C.build_retriever_cell("colpali", shape, dev, generator=gen(),
                               mesh=card41)
    DSP.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        op, tp = part_timed(lambda: c.fn(*c.args), n)
    peak = torch.cuda.max_memory_allocated() / 1e9
    pool_launches = DSP.launch_count("pooling")
    check(pool_launches == 4 * (1 + n), f"(b) index: pool.cu launched "
          f"{pool_launches} times, want one per position and call "
          f"({4 * (1 + n)})")
    same_bits(op[0][0], o1[0][0], "(b) index vectors (mesh vs one device)")
    off = (op[0][1].float() - o1[0][1].float()).abs()
    check(bool((off <= 2.0 ** -7 * o1[0][1].float().abs() + 1e-6).all()),
          "(b) index: pooled vectors more than one bf16 step from the "
          "one-device cell's")
    ms, ms1 = statistics.median(tp), statistics.median(t1)
    log(f"[partitioned] (b) colpali index_1m, {shape.pages_per_step} pages "
        f"on (4, 1): {ms:.1f} ms a call (median of {n}; one device "
        f"{ms1:.1f}, ratio {ms / ms1:.2f}), "
        f"{shape.pages_per_step / (ms / 1e3):.1f} pages/s; pool.cu launched "
        f"{pool_launches} times ({1 + n} calls x 4 positions); vectors bit "
        f"for bit and pooled within one bf16 step of the one-device cell "
        f"(max {float(off.max()):.2e}); {part_traffic_line(n)}; peak "
        f"{peak:.2f} GB")
    out["index"] = dict(ms=ms, one_ms=ms1, launches=pool_launches)
    del c, op, o1
    gc.collect()
    torch.cuda.empty_cache()
    return out


def part_gemma(args, dev, card14, card22) -> dict:
    """gemma3-4b at full width in f32: prefill on (1, 4) against the
    one-device prefill (last logits), then 16 decode steps on (2, 2) from
    the one-device prefill's caches, fed the one-device greedy tokens:
    the partitioned greedy token equals the one-device one apart from
    near-ties within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import shard_map as SM
    from repro_torch.distributed.sharding import ShardingPolicy, device_put
    from repro_torch.launch import cells as C
    from repro_torch.models import kv_cache as KV
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("gemma3-4b"), dtype="float32")
    B, S, n_dec = (PART_SIZES["gemma_batch"], PART_SIZES["gemma_seq"],
                   PART_SIZES["n_dec"])
    n = PART_SIZES["timed"]
    torch.cuda.empty_cache()

    def gen():
        return torch.Generator(device=dev).manual_seed(args.seed)
    with patched_config(cfg):
        one = C.build_lm_cell("gemma3-4b", part_shape(
            "prefill", seq_len=S, global_batch=B), dev, generator=gen())
        model, batch = one.args
        with torch.no_grad():
            o1, t1 = part_timed(lambda: T.prefill_step(
                model, batch, decode_budget=n_dec), n)
        logits1, caches1 = o1[0]
        del o1
        p = C.build_lm_cell("gemma3-4b", part_shape(
            "prefill", seq_len=S, global_batch=B), dev, generator=gen(),
            mesh=card14)
        torch.cuda.reset_peak_memory_stats()
        op, tp = part_timed(lambda: p.fn(*p.args), n)
        peak = torch.cuda.max_memory_allocated() / 1e9
        near_pf = greedy_match(op[0][0], logits1, "(b) gemma3 prefill")
        err = float((op[0][0].float() - logits1.float()).abs().max())
        pf = (statistics.median(tp), statistics.median(t1))
        log(f"[partitioned] (b) gemma3-4b prefill {B} x {S}, f32, on "
            f"(1, 4) (Megatron-SP residual): {pf[0]:.1f} ms (median of {n};"
            f" one device {pf[1]:.1f}, ratio {pf[0] / pf[1]:.2f}); the last "
            f"position's greedy tokens equal the one-device prefill's "
            f"({near_pf} near-ties within 1e-4), logits max abs err "
            f"{err:.2e}; "
            f"{part_state_line(p.args[0])}; {part_traffic_line(n)}; "
            f"peak {peak:.2f} GB")
        del p, op
        gc.collect()
        torch.cuda.empty_cache()
        # the prefill's caches placed on (2, 2) before the one-device
        # greedy decode writes them; then the same tokens on (2, 2)
        pol = ShardingPolicy(card22)
        caches = device_put(caches1, KV.cache_shardings(
            cfg, T.segment_plan(cfg), B, pol), copy=True)
        with torch.no_grad():
            tok = logits1.argmax(-1)
            ones, steps1, t_one = [], [], []
            for i in range(n_dec):
                (lg, _), ms = event_ms(lambda: T.decode_step(
                    model, caches1, tok, S + i))
                steps1.append(lg)
                ones.append(tok)
                t_one.append(ms)
                tok = lg.argmax(-1)
        del caches1
        d = C.build_lm_cell("gemma3-4b", part_shape(
            "decode", seq_len=S + n_dec, global_batch=B), dev,
            generator=gen(), mesh=card22)
        check(all(a.sharding == b.sharding for sa, sb in zip(caches, d.args[1])
                  for xa, xb in zip(sa, sb) for a, b in
                  ((xa["k"], xb["k"]), (xa["v"], xb["v"]))),
              "(b) gemma3: the placed caches' shardings are not the decode "
              "cell's")
        near, t_part, worst = 0, [], 0.0
        for k in SM.TRAFFIC:
            SM.TRAFFIC[k] = 0
        torch.cuda.reset_peak_memory_stats()
        for i in range(n_dec):
            lg, ms = event_ms(lambda: d.fn(d.args[0], caches, device_put(
                ones[i].to(torch.int32), d.args[2].sharding, copy=True),
                device_put(torch.tensor(S + i, dtype=torch.int32),
                           d.args[3].sharding, copy=True)))
            t_part.append(ms)
            worst = max(worst, float((lg.float() - steps1[i].float()
                                      ).abs().max()))
            near += greedy_match(lg, steps1[i], f"(b) gemma3 decode step {i}")
        dm = (statistics.median(t_part[1:]), statistics.median(t_one[1:]))
        log(f"[partitioned] (b) gemma3-4b {n_dec} decode steps on (2, 2) "
            f"(batch {B} over dp, caches of {S + n_dec} slots over sp), "
            f"f32: {dm[0]:.2f} ms/step (median; one device {dm[1]:.2f}, "
            f"ratio {dm[0] / dm[1]:.2f}); greedy tokens equal the one-device"
            f" run's ({near} near-ties within 1e-4), logits max abs err "
            f"{worst:.2e}; {part_state_line(d.args[0])}; "
            f"{part_traffic_line(n_dec)}; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del d, model, batch, one, caches
        gc.collect()
        torch.cuda.empty_cache()
    return dict(prefill_ms=pf[0], prefill_one_ms=pf[1], decode_ms=dm[0],
                decode_one_ms=dm[1], near=near + near_pf, logits_err=worst)


def greedy_match(got, want, what: str) -> int:
    """Each row's greedy token of ``got`` [B, 1, V] equals ``want``'s apart
    from near-ties: where they differ, ``want``'s logit of its own token
    exceeds its logit of ``got``'s by at most 1e-4. Returns the near-ties."""
    got, want = got.float().cpu(), want.float().cpu()
    g, w = got.argmax(-1), want.argmax(-1)
    near = 0
    for r, c in zip(*torch.nonzero(g != w, as_tuple=True)):
        gap = float(want[r, c, w[r, c]] - want[r, c, g[r, c]])
        check(gap <= 1e-4, f"{what} row {int(r)}: greedy {int(g[r, c])} != "
              f"one device {int(w[r, c])} (logit gap {gap:.3e} > 1e-4)")
        near += 1
    return near


def part_recsys_cfg(arch: str):
    """``tests/test_torch_partitioned_recsys.py``'s config: the CPU tests'
    sizes, a CTR arch's item field at 120001 rows (the big table exists,
    its rows padded to the tp shards), dlrm-mlperf 16 wide."""
    cfg = recsys_reduced(arch)
    if arch == "bert4rec":
        return cfg
    vocab = list(cfg.vocab_sizes)
    vocab[2] = 120_001
    cfg = dataclasses.replace(cfg, vocab_sizes=tuple(vocab))
    if arch == "dlrm-mlperf":
        cfg = dataclasses.replace(cfg, embed_dim=16, bot_mlp=(32, 16))
    return cfg


class recsys_small_calls:
    """The tests' cuts inside: ``serve_step`` chunks of 8, candidates
    scored 32 at a time, a prefetch of 32 and a top 10 (``small``); or
    only ``serve_step``'s chunk set to ``chunk``."""

    def __init__(self, small: bool = True, chunk: int = 8):
        self.small, self.chunk = small, chunk

    def __enter__(self):
        from repro_torch.models.recsys import nets as R
        self.serve = R.serve_step.__wrapped__
        self.ret = R.retrieval_step.__wrapped__
        self.old = (self.serve.__defaults__, self.ret.__kwdefaults__,
                    R.CAND_CHUNK)
        self.serve.__defaults__ = (self.chunk, None)
        if self.small:
            self.ret.__kwdefaults__ = dict(self.ret.__kwdefaults__,
                                           prefetch_k=32, top_k=10)
            R.CAND_CHUNK = 32

    def __exit__(self, *exc):
        from repro_torch.models.recsys import nets as R
        (self.serve.__defaults__, self.ret.__kwdefaults__,
         R.CAND_CHUNK) = self.old


def ids_tied(ids, scores, ids1, scores1, tie: float, what: str) -> int:
    """``ids`` equal ``ids1`` apart from ties: where they differ at a rank,
    ``scores1`` there lies within ``tie`` of a neighbour's. Returns the
    ranks that differ; the scores must agree (rtol 1e-5, atol 1e-6)."""
    close(scores, scores1, 1e-5, 1e-6, f"{what} scores")
    ids, ids1 = ids.cpu().numpy(), ids1.cpu().numpy()
    sc = scores1.float().cpu().numpy()
    differ = np.flatnonzero(ids != ids1)
    for j in differ:
        near = [abs(sc[j] - sc[jj]) <= tie for jj in (j - 1, j + 1)
                if 0 <= jj < len(sc)]
        check(any(near), f"{what}: id at rank {j} differs without a tie "
              f"within {tie}")
    return len(differ)


def part_recsys_card_vs_cpu(args) -> dict:
    """(a) the recsys cells at the CPU tests' sizes in f32 on
    ``["cuda:0"] * 4`` against ``["cpu"] * 4`` (the same seeded weights
    and inputs), on (2, 2) and (1, 4): a train step (``part_step_close``),
    ``serve_p99`` (8 rows), ``serve_bulk`` (32 rows in chunks of 8; rtol
    1e-5, atol 1e-6) and ``retrieval_cand`` base and opt over 301
    candidates padded to 304 (ids equal apart from ties within 1e-5)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import cells as C

    shapes = {"train": ShapeSpec("train_batch", "train", {"batch": 16}),
              "p99": ShapeSpec("serve_p99", "serve", {"batch": 8}),
              "bulk": ShapeSpec("serve_bulk", "serve", {"batch": 32}),
              "ret": ShapeSpec("retrieval_cand", "retrieval",
                               {"batch": 1, "n_candidates": 301})}
    out = {}
    for arch in PART_RECSYS:
        for mshape in ((2, 2), (1, 4)):
            where = f"({mshape[0]}, {mshape[1]})"
            res = []
            with patched_config(part_recsys_cfg(arch)), recsys_small_calls():
                for mesh in shard_meshes(mshape, ("data", "model")):
                    def build(kind, variant="base"):
                        return C.build_recsys_cell(
                            arch, shapes[kind], variant=variant, mesh=mesh,
                            generator=torch.Generator().manual_seed(
                                args.seed))
                    r = {}
                    c = build("train")
                    r["train"] = (c.fn(*c.args), c.args[0], c.args[1])
                    for kind in ("p99", "bulk"):
                        c = build(kind)
                        r[kind] = c.fn(*c.args)
                    for variant in ("base", "opt"):
                        c = build("ret", variant)
                        r[variant] = c.fn(*c.args)
                    res.append(r)
            card, cpu = res
            st = part_step_close(f"{arch} train_batch on {where}",
                                 card["train"], cpu["train"],
                                 float(cpu["train"][0]["lr"]))
            serve = max(close(card[k], cpu[k], 1e-5, 1e-6,
                              f"(a) {arch} {k} on {where}")
                        for k in ("p99", "bulk"))
            swaps = sum(ids_tied(card[v][1], card[v][0], cpu[v][1],
                                 cpu[v][0], 1e-5,
                                 f"(a) {arch} retrieval_cand {v} on {where}")
                        for v in ("base", "opt"))
            out[f"{arch} {where}"] = dict(st, serve=serve, swaps=swaps)
            log(f"[partitioned] (a) {arch} on {where}: train_batch loss "
                f"{float(card['train'][0]['loss']):.7f} vs CPU mesh "
                f"{float(cpu['train'][0]['loss']):.7f} (rel err "
                f"{st['loss_rel']:.2e}, rtol 1e-5), every moment and "
                f"row-wise accumulator within rtol 1e-3, parameters rtol "
                f"1e-5; serve_p99 and serve_bulk (chunks of 8) max abs err "
                f"{serve:.2e} (rtol 1e-5, atol 1e-6); retrieval_cand base "
                f"and opt ids equal ({swaps} differ at ties within 1e-5)")
    return out


def part_place_host(host: dict, like: dict) -> dict:
    """The host leaves ``host`` placed by the shardings of ``like``'s
    (meta) slabs; a leaf shorter than its placed shape (a big table whose
    rows the mesh pads to its tp shards) is padded with zero rows."""
    from repro_torch.distributed.sharding import device_put
    out = {}
    for n, s in like.items():
        x = host[n]
        if tuple(x.shape) != tuple(s.shape):
            x = torch.cat([x, x.new_zeros((s.shape[0] - x.shape[0],)
                                          + tuple(x.shape[1:]))])
        out[n] = device_put(x, s.sharding, copy=True)
    return out


def part_recsys_full(args, dev) -> dict:
    """(b) each recsys arch at full width on its ``PART_RECSYS`` mesh,
    beside the one-device cells on the same weights and inputs."""
    return {arch: part_recsys_arch(args, dev, arch, mshape)
            for arch, mshape in PART_RECSYS.items()}


def part_recsys_arch(args, dev, arch: str, mshape: tuple) -> dict:
    """One arch's cells, ``serve_p99`` (512 rows), ``serve_bulk`` (262144
    rows), ``retrieval_cand`` base and opt (10^6 candidates) and
    ``train_batch`` (65536 rows; bert4rec 8192), first on one device
    (the model and inputs drawn from the seed, the weights kept on the
    host), then on the mesh (the same weights placed from the host, the
    same inputs placed): ms per call or step, the outputs' largest
    difference (rtol 1e-4, atol 1e-5: other GEMM shapes), candidate ids
    equal apart from ties within 1e-5, the first step's loss within rtol
    1e-5, bytes a position holds of the parameters and optimizer state,
    bytes per collective, peak memory."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed.sharding import device_put
    from repro_torch.launch import cells as C
    from repro_torch.models.recsys import nets as R
    from repro_torch.training import optimizer as OPT

    t0 = time.perf_counter()
    cfg = recsys_config(arch)
    mesh, _ = shard_meshes(mshape, ("data", "model"))
    where = f"({mshape[0]}, {mshape[1]})"
    n = PART_SIZES["timed"]
    B_train = PART_SIZES["b4r_train"] if arch == "bert4rec" else \
        RECSYS_SIZES["train"]
    N = RECSYS_SIZES["n_cand"]
    shapes = {"train": ShapeSpec("train_batch", "train", {"batch": B_train}),
              "p99": ShapeSpec("serve_p99", "serve",
                               {"batch": RECSYS_SIZES["p99"]}),
              "bulk": ShapeSpec("serve_bulk", "serve",
                                {"batch": RECSYS_SIZES["bulk"]}),
              "ret": ShapeSpec("retrieval_cand", "retrieval",
                               {"batch": 1, "n_candidates": N})}
    runs = (("p99", "base"), ("bulk", "base"), ("ret", "base"),
            ("ret", "opt"), ("train", "base"))
    with patched_config(cfg):
        one = {r: C.build_recsys_cell(arch, shapes[r[0]], "meta", r[1])
               for r in runs}
        part = {r: C.build_recsys_cell(arch, shapes[r[0]], "meta", r[1],
                                       mesh=mesh) for r in runs}
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = R.init_params(cfg, gen, dev)
    host = {m: model.jax_leaf_params(m)[0].detach().to("cpu", copy=True)
            for m in model.jax_leaf_names()}
    inputs = {"p99": recsys_batch(cfg, RECSYS_SIZES["p99"], dev, gen,
                                  "serve"),
              "bulk": recsys_batch(cfg, RECSYS_SIZES["bulk"], dev, gen,
                                   "serve"),
              "train": recsys_batch(cfg, B_train, dev, gen, "train")}
    q = recsys_batch(cfg, 1, dev, gen, "query")
    rows = cfg.n_items if arch == "bert4rec" else \
        cfg.vocab_sizes[R._item_field(cfg)]
    q["candidates"] = torch.randint(0, rows, (N,), generator=gen, device=dev)
    inputs["base"] = q
    inputs["opt"] = dict(q, cand_proxy=torch.randn((N, 16), generator=gen,
                                                   device=dev))

    # bert4rec's bulk chunks: 16384 rows (with 32768 the other positions'
    # item rows, held at a collective, ran the card out of memory)
    chunk = PART_SIZES["b4r_bulk_chunk"] if arch == "bert4rec" else \
        RECSYS_SIZES["chunk"]

    def timed(fn, kind):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if kind == "bulk":
            with recsys_small_calls(small=False, chunk=chunk):
                outs, t = part_timed(fn, PART_SIZES["bulk_timed"],
                                     warm=False)
        else:
            outs, t = part_timed(fn, n)
        return outs, statistics.median(t), \
            torch.cuda.max_memory_allocated() / 1e9

    def key(r):
        return r[1] if r[0] == "ret" else r[0]

    got1 = {}
    labels = OPT.default_labels(dict(model.named_parameters()))
    for r in runs:
        if r[0] == "train":
            st = OPT.init_opt_state(dict(model.named_parameters()), labels)
            outs, ms, peak = timed(lambda: one[r].fn(model, st,
                                                     inputs["train"]), "train")
            got1[r] = (float(outs[0]["loss"]), ms, peak)
            del st
        else:
            with torch.no_grad():
                outs, ms, peak = timed(lambda: one[r].fn(model,
                                                         inputs[key(r)]),
                                       r[0])
            got1[r] = (outs[0], ms, peak)
        del outs
    del model
    gc.collect()
    torch.cuda.empty_cache()
    params = part_place_host(host, part[runs[0]].args[0])
    del host
    res = {}
    for r in runs:
        cell = part[r]
        b = device_put(inputs[key(r)], {k: v.sharding for k, v in
                                        cell.args[-1].items()}, copy=True)
        what = f"(b) {arch} {shapes[r[0]].name} {r[1]} on {where}"
        if r[0] == "train":
            st = OPT.init_opt_state(params, OPT.default_labels(params))
            outs, ms, peak = timed(lambda: cell.fn(params, st, b), "train")
            l1 = got1[r][0]
            lp = [float(m["loss"]) for m in outs]
            gap = abs(lp[0] - l1) / abs(l1)
            check(np.isfinite(lp).all() and gap <= 1e-5, f"{what}: loss "
                  f"{lp[0]!r} vs one device {l1!r} (rel gap {gap:.2e})")
            line = (f"first-step loss {lp[0]:.7f} vs one device {l1:.7f} "
                    f"(rel gap {gap:.2e}, limit 1e-5); "
                    f"{part_state_line(params, st)}")
            res["train"] = dict(gap=gap)
        elif r[0] == "ret":
            outs, ms, peak = timed(lambda: cell.fn(params, b), "ret")
            (s, i), (s1, i1) = outs[0], got1[r][0]
            sw = ids_tied(i, s, i1, s1, 1e-5, what)
            line = (f"top {i.shape[0]} ids equal the one-device cell's "
                    f"({sw} differ at ties within 1e-5), scores max abs "
                    f"diff {float((s - s1).abs().max()):.2e}")
            res[r[1]] = dict(swaps=sw)
        else:
            outs, ms, peak = timed(lambda: cell.fn(params, b), r[0])
            o, o1 = outs[0], got1[r][0]
            err = float((o.float() - o1.float()).abs().max())
            check(bool(torch.allclose(o, o1, rtol=1e-4, atol=1e-5)),
                  f"{what}: output max abs diff {err:.3e} from the "
                  "one-device cell (rtol 1e-4, atol 1e-5)")
            line = f"output max abs diff {err:.2e} from the one-device cell"
            res[r[0]] = dict(err=err)
        one_ms, one_peak = got1[r][1], got1[r][2]
        res.setdefault(key(r), {}).update(ms=ms, one_ms=one_ms, peak_gb=peak)
        calls = (f"{PART_SIZES['bulk_timed']} call, no warm-up, chunks of "
                 f"{chunk}" if r[0] == "bulk" else f"median of {n}")
        log(f"[partitioned] {what}: {ms:.2f} ms ({calls}; one device "
            f"{one_ms:.2f}, ratio {ms / one_ms:.2f}); {line}; "
            f"{part_traffic_line(PART_SIZES['bulk_timed'] if r[0] == 'bulk' else n)}"
            f"; peak {peak:.2f} GB (one device {one_peak:.2f})")
        del outs, b
    log(f"[partitioned] (b) {arch} on {where}: {len(runs)} cells in "
        f"{time.perf_counter() - t0:.1f}s")
    del params, inputs, q, got1
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    return res


def part_path(args, dev) -> dict:
    """Phase 4r: the partitioned cells on 4 positions of this one card:
    (a) against the CPU mesh at the tests' sizes, (b) at full width
    beside the one-device cells."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    res = {"a": part_card_vs_cpu(args)}
    t1 = time.perf_counter()
    res["a_recsys"] = part_recsys_card_vs_cpu(args)
    t2 = time.perf_counter()
    log(f"[partitioned] (a) {t2 - t0:.1f}s (the recsys cells "
        f"{t2 - t1:.1f}s)")
    res["b"] = part_full(args, dev)
    t3 = time.perf_counter()
    res["b_recsys"] = part_recsys_full(args, dev)
    t4 = time.perf_counter()
    res["seconds"] = t4 - t0
    gb = res["b"]
    new = (t2 - t1) + (t4 - t3) + sum(
        gb[f"full_graph_{v}"]["seconds"] for v in ("base", "opt"))
    log(f"[partitioned] (b) {t4 - t2:.1f}s (the recsys cells "
        f"{t4 - t3:.1f}s); the recsys and full_graph_sm parts "
        f"{new:.1f}s in all")
    log(f"[partitioned] phase 4r {res['seconds']:.1f}s")
    return res


# ---------------------------------------------------------------------------
# 4s. the dry run (every cell sized on the production mesh)
# ---------------------------------------------------------------------------

# 4s (a): the 101 cells on the 16 x 16 meta mesh in this many worker
# processes (the card waits: nothing runs there); the decoder LMs' opt
# train cells (8 checkpointed microbatches) go first, being the longest
DRY_WORKERS = 8


def dry_cell(key: str) -> dict:
    """One cell of 4s (a), in a worker process: ``launch.dryrun.run_cell``
    on the 16 x 16 meta mesh, or the failure as ``dryrun`` reports it;
    and whether the worker touched CUDA."""
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun as DR
    arch, shape, variant = key.split("|")
    try:
        r = DR.run_cell(arch, shape, DR.meta_mesh("single"), "single",
                        variant)
    except Exception as e:  # noqa: BLE001 - reported, then checked
        r = DR.failed(arch, shape, "single", variant, e)
    r["cuda_initialized"] = torch.cuda.is_initialized()
    return r


def dry_line(r: dict, total: int) -> str:
    m, gb = r["memory"], 1e9
    coll = ", ".join(f"{k} {v / gb:.3f}" for k, v in
                     r["collectives"]["bytes"].items() if v) or "none"
    fits = "fits" if m["peak_bytes"] <= total else "does NOT fit"
    return (f"[dry] (a) {r['arch']} {r['shape']} {r['variant']}: a position "
            f"holds {m['held_bytes'] / gb:.3f} GB (reads "
            f"{m['argument_bytes'] / gb:.3f}), peak {m['peak_bytes'] / gb:.3f}"
            f" GB, {r['struct']['flops'] / 1e12:.3f} TFLOP, collectives GB: "
            f"{coll}; {fits} this card ({r['seconds']:.1f}s)")


def dry_cells(args, dev) -> dict:
    """4s (a): every cell of ``get_cells(ALL_ARCHS)`` x its variants on
    the 16 x 16 meta mesh, in worker processes; all must be ok, and this
    process's device memory must not move."""
    import concurrent.futures as CF
    import multiprocessing as mp
    from repro_torch.configs import ALL_ARCHS, get_cells
    from repro_torch.launch import cells as C

    total = torch.cuda.get_device_properties(dev).total_memory
    keys = [f"{a}|{s}|{v}" for a, s in get_cells(ALL_ARCHS)
            for v in C.variants(a, s)]
    check(len(keys) == 101, f"{len(keys)} cells, not 101")
    order = sorted(keys, key=lambda k: not (k.endswith("|opt") and
                                            "train_4k" in k))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    with CF.ProcessPoolExecutor(DRY_WORKERS,
                                mp_context=mp.get_context("spawn")) as ex:
        got = dict(zip(order, ex.map(dry_cell, order)))
    secs = time.perf_counter() - t0
    check(torch.cuda.memory_allocated(dev) == before,
          "4s (a): device memory moved during the dry run")
    res = {k: got[k] for k in keys}
    for r in res.values():
        check(r["ok"], f"4s (a) {r['arch']} {r['shape']} {r['variant']}: "
              f"{r.get('error')}")
        check(not r["cuda_initialized"], f"4s (a) {r['arch']} "
              f"{r['shape']}: the dry run touched CUDA")
        log(dry_line(r, total))
    fits = [k for k, r in res.items() if r["memory"]["peak_bytes"] <= total]
    log(f"[dry] (a) 101/101 cells ok on the 16 x 16 meta mesh, "
        f"{len(fits)} fit one position of this card ({total} bytes); not: "
        f"{sorted(set(keys) - set(fits))}; device memory unchanged "
        f"({before} bytes allocated); {secs:.1f}s in {DRY_WORKERS} worker "
        f"processes ({sum(r['seconds'] for r in res.values()):.1f}s of "
        "cells)")
    return {"n_fit": len(fits), "seconds": secs, "total": total}


def dry_vs_card(args, dev) -> dict:
    """4s (b): three of 4r's placed cells at 4r's sizes, the dry run of
    each (a meta mesh of its shape) beside the card: its held bytes, over
    the 4 positions of ``cuda:0``, within 1% of the growth of
    ``memory_allocated`` over the build; its per-position peak printed
    beside ``max_memory_allocated`` over one step."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import cells as C
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_mesh

    cases = (
        ("minicpm-2b train_4k base, 16 of 40 layers, batch 2 x 4096, bf16",
         "minicpm-2b", C.build_lm_cell, dataclasses.replace(
             get_config("minicpm-2b"), n_layers=PART_SIZES["lm_layers"]),
         part_shape("train", seq_len=PART_SIZES["lm_seq"],
                    global_batch=PART_SIZES["lm_batch"]), (2, 2)),
        ("dlrm-mlperf train_batch (4m's capped table), batch 65536",
         "dlrm-mlperf", C.build_recsys_cell, recsys_config("dlrm-mlperf"),
         ShapeSpec("train_batch", "train",
                   {"batch": RECSYS_SIZES["train"]}), (1, 4)),
        (f"bert4rec train_batch, batch {PART_SIZES['b4r_train']}",
         "bert4rec", C.build_recsys_cell, recsys_config("bert4rec"),
         ShapeSpec("train_batch", "train",
                   {"batch": PART_SIZES["b4r_train"]}), (2, 2)))
    out = {}
    for what, arch, build, cfg, shape, mshape in cases:
        n = int(np.prod(mshape))
        axes = ("data", "model")
        with patched_config(cfg):
            dry = DR.count_cell(build(arch, shape, "meta", mesh=make_mesh(
                mshape, axes, devices=["meta"] * n)))
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            a0 = torch.cuda.memory_allocated(dev)
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            cell = build(arch, shape, dev, generator=gen,
                         mesh=make_mesh(mshape, axes,
                                        devices=["cuda:0"] * n))
            torch.cuda.synchronize()
            grown = torch.cuda.memory_allocated(dev) - a0
            held = n * dry["memory"]["held_bytes"]
            err = abs(held - grown) / max(grown, 1)
            torch.cuda.reset_peak_memory_stats(dev)
            m = cell.fn(*cell.args)
            check(bool(torch.isfinite(m["loss"])), f"4s (b) {what}: loss "
                  "not finite")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - a0
            del cell, m
        gc.collect()
        torch.cuda.empty_cache()
        pk = dry["memory"]["peak_bytes"]
        log(f"[dry] (b) {what}, on {mshape}: held by the dry run "
            f"{dry['memory']['held_bytes'] / 1e9:.4f} GB a position, x {n} "
            f"= {held / 1e9:.4f} GB; the card grew {grown / 1e9:.4f} GB over "
            f"the build ({100 * err:.3f}% apart); peak a position by the dry "
            f"run {pk / 1e9:.3f} GB, x {n} = {n * pk / 1e9:.3f} GB; one "
            f"step's max_memory_allocated above the memory before the "
            f"build {peak / 1e9:.3f} GB ({n} positions taking turns on one "
            "card)")
        check(err <= 0.01, f"4s (b) {what}: held bytes {held} vs the card's "
              f"growth {grown}, {100 * err:.3f}% apart (limit 1%)")
        out[arch] = dict(held=held, grown=grown, err=err, peak_dry=pk,
                         peak_card=peak, n=n)
    return out


def dry_path(args, dev) -> dict:
    """Phase 4s: (a) the dry run of every cell on the 16 x 16 meta mesh,
    (b) three placed cells' dry runs beside the card."""
    t0 = time.perf_counter()
    res = {"a": dry_cells(args, dev)}
    t1 = time.perf_counter()
    res["b"] = dry_vs_card(args, dev)
    res["seconds"] = time.perf_counter() - t0
    log(f"[dry] phase 4s {res['seconds']:.1f}s ((a) {t1 - t0:.1f}s, (b) "
        f"{res['seconds'] - (t1 - t0):.1f}s)")
    return res


def audit_ids(sc, out, ref, what: str) -> int:
    """4t (d): a scenario's card output against its CPU run's: the
    ingest's int8 codes bit for bit, search ids equal apart from
    near-exact ties (``row_swaps`` over the CPU scores, within 1e-4) and
    scores within rtol 1e-5, atol 1e-4. Returns the tie-swapped
    positions."""
    got, want = sc.key(out).cpu(), sc.key(ref).cpu()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs "
          f"the CPU's {tuple(want.shape)}")
    if got.dtype == torch.int8:
        check(bool(torch.equal(got, want)), f"{what}: int8 codes differ "
              "from the CPU's")
        return 0
    sc_k, sc_p = out[0].float().cpu().numpy(), ref[0].float().cpu().numpy()
    check(np.isfinite(sc_k).all() and np.isfinite(sc_p).all(),
          f"{what}: non-finite scores")
    check(np.allclose(sc_k, sc_p, rtol=1e-5, atol=1e-4),
          f"{what}: scores differ beyond rtol=1e-5, atol=1e-4 (max "
          f"{np.abs(sc_k - sc_p).max():.3e})")
    ids_k, ids_p = got.numpy(), want.numpy()
    swaps = 0
    for r in range(ids_k.shape[0]):
        m, j = row_swaps(ids_k[r], ids_p[r], sc_p[r], 1e-4)
        if j is not None:
            fail(f"{what}: query {r} rank {j} id {ids_k[r, j]} != "
                 f"{ids_p[r, j]} without a tie")
        swaps += m
    return swaps


def audit_path(args, dev) -> dict:
    """Phase 4t: the contract auditor, (a) the AST layer, (b) the op
    audit's scenarios with their kernels, (c) each body sync-free under
    ``set_sync_debug_mode("error")``, (d) ids against the CPU, (e) memory
    growth beside the audit's largest op output."""
    from repro_torch.analysis import apply_baseline, load_baseline
    from repro_torch.analysis import op_audit as OA
    from repro_torch.analysis.astlint import lint_tree
    from repro_torch.kernels import dispatch as DSP

    t0 = time.perf_counter()
    before = {k: DSP.launch_count(k) for k in DSP.KERNELS}
    root = Path(__file__).resolve().parent
    allow = load_baseline(root / "src" / "repro_torch" / "analysis"
                          / "baseline.json")
    fs = lint_tree(root / "src", repo_root=root)
    gated, _ = apply_baseline(fs, allow)
    check(not gated, "4t (a) the AST layer has gated findings: " + "; ".join(
        f"{f.rule} {f.path}:{f.line} [{f.symbol}]" for f in gated))
    n_mod = len(list((root / "src" / "repro_torch").rglob("*.py")))
    log(f"[audit] (a) AST layer over {n_mod} modules of src/repro_torch: "
        f"{len(fs)} findings, 0 gated (baseline of {len(allow)})")
    cpu = torch.device("cpu")
    rows, sync_free = {}, []
    for name, make in OA.SCENARIOS.items():
        sc = make(dev)
        # (b) the audit's two calls: the first warms the body
        f, m, out = OA.audit_scenario(sc)
        gated, _ = apply_baseline(f, allow)
        check(not gated, f"4t (b) {name}: gated findings: " + "; ".join(
            f"{x.rule} [{x.symbol}] {x.message}" for x in gated))
        for k in sc.kernels:
            check(m["launches"].get(k, 0) > 0, f"4t (b) {name}: kernel {k} "
                  f"was never launched (launches {m['launches']})")
        # (c) one more call under the sync debug mode: a synchronising
        # CUDA call raises there
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                sc.body(*sc.args)
        except RuntimeError as e:
            fail(f"4t (c) {name}: a synchronising CUDA call in the body: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sync_free.append(name)
        # (e) memory growth over one warm call
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        with torch.no_grad():
            sc.body(*sc.args)
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_allocated(dev) - base
        # (d) the CPU's run of the same scenario
        ref_sc = make(cpu)
        with torch.no_grad():
            ref = ref_sc.body(*ref_sc.args)
        swaps = audit_ids(sc, out, ref, f"4t (d) {name}")
        rows[name] = dict(m, grown=grown, swaps=swaps)
        log(f"[audit] {name}: {m['n_ops']} ops, largest op output "
            f"{m['max_live_bytes']} B ({m['max_live_op']}), budget "
            f"{m['budget_bytes']} B, {m['syncs']} host waits, launches "
            f"{m['launches']}; sync-free under set_sync_debug_mode('error')"
            f"; max_memory_allocated growth over one call {grown} B; ids "
            f"vs the CPU: {swaps} tie-swapped positions")
    counts = {k: DSP.launch_count(k) - before[k] for k in DSP.KERNELS}
    secs = time.perf_counter() - t0
    log(f"[audit] sync-free on the card: {', '.join(sync_free)}; phase 4t "
        f"{secs:.1f}s")
    return {"rows": rows, "sync_free": sync_free, "n_ast": len(fs),
            "counts": counts, "seconds": secs}


def kernel_times(args, dev, main) -> list:
    from repro_torch.configs import get_config
    from repro_torch.kernels.maxsim import ops as KOPS
    from repro_torch.kernels.maxsim.ref import maxsim_ref
    from repro_torch.kernels.pooling import ops as POPS

    cfg = get_config("colpali")
    r = main["retriever"]
    bench = main["bench"]
    vec = r.store.vectors
    q = torch.as_tensor(bench.queries[:args.batch]).to(dev)
    qm = torch.as_tensor(bench.query_mask[:args.batch]).to(dev)
    qmf = qm.float()
    B, Q, d = q.shape
    qv = int(qm.sum())                       # valid query tokens in the batch
    entries = []

    # --- scan at the 1-stage shape (initial) and the 2-stage shape: the
    # wrapper as the main path calls it, its query packed on every call
    # (ms); the launch with the packed operand built once (kernel_ms); the
    # wrapper's calls back to back (b2b_ms); the packing alone
    for name in ("initial", "mean_pooling"):
        docs, dm = vec[name], vec[name + "_mask"]
        N, D, _ = docs.shape
        route = scan_route(docs, f"scan {name} [{N},{D},{d}]")
        check(route == "tensor", f"scan {name}: the main path's shape takes "
              "the warp route")
        op = KOPS.scan_query_operand(q, qmf)
        ms = time_ms(lambda: KOPS.maxsim_scores(q, docs, qm, dm))
        kern = time_ms(lambda: KOPS.maxsim_scores(q, docs, qmf, dm,
                                                  operand=op))
        b2b = time_ms(lambda: KOPS.maxsim_scores(q, docs, qm, dm), reps=5)
        pack = time_ms(lambda: KOPS.scan_query_operand(q, qmf))
        plain = time_ms(lambda: chunked_scan_ref(maxsim_ref, q, qmf, docs, dm), iters=3)

        def library():
            sim = torch.einsum("bqd,njd->bnqj", q, docs.float())
            sim.masked_fill_(~dm[None, :, None, :], NEG)
            best = sim.amax(-1).clamp_min(NEG / 2)
            return torch.where(qm[:, None, :], best, 0.0).sum(-1)
        lib = time_ms(library, iters=3)
        nbytes = (q.numel() * 4 + qm.numel() * 4 + docs.numel() * 2
                  + dm.numel() + B * N * 4)
        flops = 2.0 * qv * int(dm.sum()) * d
        b_ms, b_by = bound_split_bf16(nbytes, flops)
        log(f"[times] scan {name} q[{B},{Q},{d}] ({qv} valid tokens) "
            f"docs[{N},{D},{d}] bf16, {route} route: wrapper {ms:.4f} ms "
            f"(launch with the query packed once {kern:.4f} ms, wrapper "
            f"back to back {b2b:.4f} ms, packing alone {pack:.4f} ms), "
            f"plain {plain:.3f} ms, library {lib:.4f} ms, split bf16 bound "
            f"{b_ms:.4f} ms ({b_by}), wrapper at {100 * b_ms / ms:.1f}% "
            f"and launch at {100 * b_ms / kern:.1f}% of it; "
            f"{flops / kern / 1e9:.1f} f32 TFLOP/s equivalent")
        log_bounds(f"scan {name}", ms, nbytes, flops)
        if name == "initial":
            entries.append(dict(
                name="maxsim_scan", route="cuda",
                source="src/repro_torch/csrc/maxsim_scan.cu",
                replaces="src/repro/kernels/maxsim/maxsim.py:80",
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, kernel_ms=kern, b2b_ms=b2b,
                shape=f"q[{B},{Q},{d}] docs[{N},{D},{d}]"))

    # --- rerank at the 2-stage final shape: rows [B, 256] onto initial:
    # the wrapper as the main path calls it, its query packed on every
    # call (ms); the launch with the packed operand built once
    # (kernel_ms); the wrapper's calls back to back (b2b_ms)
    docs, dm = vec["initial"], vec["initial_mask"]
    N, D, _ = docs.shape
    s0 = KOPS.maxsim_scores(q, vec["mean_pooling"], qm,
                            vec["mean_pooling_mask"])
    rows = torch.sort(s0, dim=-1, descending=True,
                      stable=True)[1][:, :256].to(torch.int32)
    L = rows.shape[1]
    route = scan_route(docs, f"rerank initial [{N},{D},{d}]",
                       kernel="rerank")
    check(route == "tensor", "rerank initial: the main path's shape takes "
          "the warp route")
    op = KOPS.scan_query_operand(q, qmf)
    ms = time_ms(lambda: KOPS.maxsim_rerank(q, docs, rows, qm, dm))
    kern = time_ms(lambda: KOPS.maxsim_rerank(q, docs, rows, qmf, dm,
                                              operand=op))
    b2b = time_ms(lambda: KOPS.maxsim_rerank(q, docs, rows, qm, dm), reps=5)
    plain = time_ms(lambda: KOPS._rerank_ref(q, docs, rows, qmf, dm),
                    iters=3)

    def library():
        g = docs.index_select(0, rows.reshape(-1).long()).float()
        g = g.view(B, L, D, d)
        sim = torch.einsum("bqd,bljd->blqj", q, g)
        gm = dm.index_select(0, rows.reshape(-1).long()).view(B, L, D)
        sim.masked_fill_(~gm[:, :, None, :], NEG)
        return torch.where(qm[:, None, :], sim.amax(-1), 0.0).sum(-1)
    lib = time_ms(library, iters=3)
    nbytes, flops, uniq = rerank_cost(q, qm, rows, dm, D, d * 2 + 1)
    b_ms, b_by = bound_split_bf16(nbytes, flops)
    log(f"[times] rerank initial rows[{B},{L}] docs[{N},{D},{d}] bf16 "
        f"({uniq} distinct candidates), {route} route: wrapper {ms:.4f} ms "
        f"(launch with the query packed once {kern:.4f} ms, wrapper back "
        f"to back {b2b:.4f} ms), plain {plain:.3f} ms, library {lib:.3f} "
        f"ms, split bf16 bound {b_ms:.4f} ms ({b_by}: the {uniq} distinct "
        f"candidates' rows and mask bytes once), wrapper at "
        f"{100 * b_ms / ms:.1f}% and launch at {100 * b_ms / kern:.1f}% of "
        f"it; {B * L * D * (d * 2 + 1) / kern / 1e6:.1f} GB/s of candidate "
        "rows (each (query, candidate) pair's) streamed by the launch")
    log_bounds("rerank initial", ms, nbytes, flops)
    entries.append(dict(
        name="maxsim_rerank", route="cuda",
        source="src/repro_torch/csrc/maxsim_rerank.cu",
        replaces="src/repro/kernels/maxsim/maxsim.py:270",
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib, kernel_ms=kern, b2b_ms=b2b,
        shape=f"rows[{B},{L}] docs[{N},{D},{d}]"))

    # --- pooling at the index batch shape: 256 pages, P [34, 1024]
    pm = torch.from_numpy(POPS.pooling_matrix_static(cfg)[0]).to(dev)
    pages = torch.as_tensor(bench.pages[:256]).to(dev)
    S_full = cfg.seq_len
    x = pages[:, S_full - cfg.n_patches:]
    m = torch.ones(x.shape[:2], dtype=torch.bool, device=dev)
    Bp, S, _ = x.shape
    n_out = pm.shape[0]
    ms = time_ms(lambda: POPS.pool_pages_fused(x, m, pm))
    b2b = time_ms(lambda: POPS.pool_pages_fused(x, m, pm), reps=5)
    plain = time_ms(lambda: POPS.pool_ref(x, m, pm))

    def library():
        mf = m.float()
        num = torch.matmul(pm, x * mf[..., None])
        out = num / torch.matmul(mf, pm.T).clamp_min(1e-9)[..., None]
        return out / out.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    lib = time_ms(library)
    nnz = int((pm != 0).sum())
    nbytes = Bp * S * d * 4 + Bp * S + n_out * S * 4 + Bp * n_out * d * 4
    flops = 2.0 * Bp * nnz * (d + 1)
    b_ms, b_by = bound(nbytes, flops)
    log(f"[times] pool x[{Bp},{S},{d}] f32 P[{n_out},{S}] ({nnz} nonzeros):"
        f" kernel {ms:.4f} ms (back to back {b2b:.4f} ms), plain "
        f"{plain:.3f} ms, library {lib:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}), kernel at {100 * b_ms / ms:.1f}% of the bound "
        f"({100 * b_ms / b2b:.1f}% back to back), "
        f"{nbytes / ms / 1e6:.1f} GB/s achieved")
    entries.append(dict(
        name="pool", route="cuda", source="src/repro_torch/csrc/pool.cu",
        replaces="src/repro/kernels/pooling/pooling.py:54",
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib, b2b_ms=b2b, shape=f"x[{Bp},{S},{d}] P[{n_out},{S}]"))
    return entries


def kernel_times_int8_and_db(args, dev, main, m8) -> list:
    """Times of the double-buffered scan, the int8 scan and the int8
    rerank at the int8 path's shapes."""
    from repro_torch.kernels.maxsim import ops as KOPS

    bench = main["bench"]
    va, vb = m8["ra"].store.vectors, m8["rb"].store.vectors
    vf = main["retriever"].store.vectors
    q = torch.as_tensor(bench.queries[:args.batch]).to(dev)
    qm = torch.as_tensor(bench.query_mask[:args.batch]).to(dev)
    qmf = qm.float()
    B, Q, d = q.shape
    qv = int(qm.sum())
    chunk = 256
    entries = []

    def library_scan(docs, dm, sc):
        """One PyTorch expression of the scan: dequantise, einsum, amax,
        sum over the whole corpus (timed only, never used by the port)."""
        df = docs.float() if sc is None else docs.float() * sc[..., None]
        sim = torch.einsum("bqd,njd->bnqj", q, df)
        sim.masked_fill_(~dm[None, :, None, :], NEG)
        best = sim.amax(-1).clamp_min(NEG / 2)
        return torch.where(qm[:, None, :], best, 0.0).sum(-1)

    def scan_cost(docs, dm, sc):
        N = docs.shape[0]
        nbytes = (q.numel() * 4 + qm.numel() * 4
                  + docs.numel() * docs.element_size()
                  + (0 if sc is None else sc.numel() * 4) + dm.numel()
                  + B * N * 4)
        return nbytes, 2.0 * qv * int(dm.sum()) * d

    # --- double-buffered scan: int8 initial (the 1-stage int8 cascade),
    # bf16 initial, int8 and bf16 mean_pooling: the wrapper as the main
    # path calls it (ms), the launch with the packed query built once
    # (kernel_ms), the wrapper's calls back to back (b2b_ms)
    op = KOPS.scan_query_operand(q, qmf)
    db = {}
    for name, docs, dm, sc in (
            ("int8 initial", va["initial_int8"], va["initial_mask"],
             va["initial_scale"]),
            ("bf16 initial", vf["initial"], vf["initial_mask"], None),
            ("int8 mean_pooling", vb["mean_pooling_int8"],
             vb["mean_pooling_mask"], vb["mean_pooling_scale"]),
            ("bf16 mean_pooling", vf["mean_pooling"],
             vf["mean_pooling_mask"], None)):
        N, D, _ = docs.shape
        route = scan_route(docs, f"db scan {name} [{N},{D},{d}]",
                           kernel="db scan")
        check(route == "tensor", f"db scan {name}: the main path's shape "
              "takes the warp route")
        ms = time_ms(lambda: KOPS.maxsim_scores_chunked(
            q, docs, qm, dm, chunk=chunk, scales=sc))
        kern = time_ms(lambda: KOPS.maxsim_scores_pipelined(
            q, docs, qmf, dm, chunk=chunk, scales=sc, operand=op))
        b2b = time_ms(lambda: KOPS.maxsim_scores_chunked(
            q, docs, qm, dm, chunk=chunk, scales=sc), reps=5)
        plain = time_ms(lambda: KOPS.maxsim_chunked_ref(
            q, docs, qmf, dm, chunk=chunk, scales=sc), iters=3)
        lib = time_ms(lambda: library_scan(docs, dm, sc), iters=3)
        nbytes, flops = scan_cost(docs, dm, sc)
        b_ms, b_by = bound_split_bf16(nbytes, flops)
        log(f"[times] db scan {name} q[{B},{Q},{d}] docs[{N},{D},{d}], "
            f"{route} route: wrapper {ms:.4f} ms (launch with the query "
            f"packed once {kern:.4f} ms, wrapper back to back {b2b:.4f} "
            f"ms), plain {plain:.3f} ms, library {lib:.3f} ms, split bf16 "
            f"bound {b_ms:.4f} ms ({b_by}), wrapper at "
            f"{100 * b_ms / ms:.1f}% and launch at {100 * b_ms / kern:.1f}%"
            f" of it; {flops / kern / 1e9:.1f} f32 TFLOP/s equivalent")
        log_bounds(f"db scan {name}", ms, nbytes, flops)
        db[name] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib, kernel_ms=kern, b2b_ms=b2b,
                        shape=f"q[{B},{Q},{d}] docs[{N},{D},{d}] "
                        f"{name.split()[0]}")
    entries.append(dict(
        name="maxsim_scan_db", route="cuda",
        source="src/repro_torch/csrc/maxsim_scan_db.cu",
        replaces="src/repro/kernels/maxsim/maxsim.py:181",
        **db["int8 initial"]))

    # --- int8 scan at the streamed top-k's chunk shape over initial codes
    # (and over the whole corpus, the db scan's work): the wrapper packing
    # its query on every call (ms), and with the packed query built once as
    # the streamed top-k does (kernel_ms)
    for lo, hi in ((0, chunk), (0, va["initial_int8"].shape[0])):
        docs = va["initial_int8"][lo:hi]
        dm, sc = va["initial_mask"][lo:hi], va["initial_scale"][lo:hi]
        N, D, _ = docs.shape
        ms = time_ms(lambda: KOPS.maxsim_scores(q, docs, qm, dm, scales=sc))
        kern = time_ms(lambda: KOPS.maxsim_scores(q, docs, qmf, dm,
                                                  scales=sc, operand=op))
        b2b = time_ms(lambda: KOPS.maxsim_scores(q, docs, qm, dm, scales=sc),
                      reps=5)
        plain = time_ms(lambda: KOPS.maxsim_chunked_ref(
            q, docs, qmf, dm, chunk=chunk, scales=sc), iters=3)
        lib = time_ms(lambda: library_scan(docs, dm, sc), iters=3)
        nbytes, flops = scan_cost(docs, dm, sc)
        b_ms, b_by = bound_split_bf16(nbytes, flops)
        log(f"[times] scan int8 initial q[{B},{Q},{d}] docs[{N},{D},{d}], "
            f"tensor route: wrapper {ms:.4f} ms (launch with the query "
            f"packed once {kern:.4f} ms, wrapper back to back {b2b:.4f} "
            f"ms), plain {plain:.3f} ms, library {lib:.3f} ms, split bf16 "
            f"bound {b_ms:.4f} ms ({b_by}), wrapper at "
            f"{100 * b_ms / ms:.1f}% and launch at {100 * b_ms / kern:.1f}%"
            f" of it; {flops / kern / 1e9:.1f} f32 TFLOP/s equivalent")
        log_bounds(f"scan int8 initial [{N}]", ms, nbytes, flops)
        if hi == chunk:
            entries.append(dict(
                name="maxsim_scan_int8", route="cuda",
                source="src/repro_torch/csrc/maxsim_scan.cu",
                replaces="src/repro/kernels/maxsim/maxsim.py:105",
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, kernel_ms=kern, b2b_ms=b2b,
                shape=f"q[{B},{Q},{d}] docs[{N},{D},{d}] int8"))

    # --- int8 rerank: rows [B, 256] onto initial codes (the 2-stage
    # cascade over the 1-stage int8 store)
    codes, sc, dm = (va["initial_int8"], va["initial_scale"],
                     va["initial_mask"])
    N, D, _ = codes.shape
    s0 = KOPS.maxsim_scores(q, vf["mean_pooling"], qm,
                            vf["mean_pooling_mask"])
    rows = torch.sort(s0, dim=-1, descending=True,
                      stable=True)[1][:, :256].to(torch.int32)
    L = rows.shape[1]
    route = scan_route(codes, f"rerank int8 initial [{N},{D},{d}]",
                       kernel="rerank")
    check(route == "tensor", "int8 rerank initial: the main path's shape "
          "takes the warp route")
    ms = time_ms(lambda: KOPS.maxsim_rerank(q, codes, rows, qm, dm,
                                            scales=sc))
    kern = time_ms(lambda: KOPS.maxsim_rerank(q, codes, rows, qmf, dm,
                                              scales=sc, operand=op))
    b2b = time_ms(lambda: KOPS.maxsim_rerank(q, codes, rows, qm, dm,
                                             scales=sc), reps=5)
    plain = time_ms(lambda: KOPS._rerank_ref(q, codes, rows, qmf, dm, sc),
                    iters=3)

    def library():
        flat = rows.reshape(-1).long()
        g = codes.index_select(0, flat).float() \
            * sc.index_select(0, flat)[..., None]
        sim = torch.einsum("bqd,bljd->blqj", q, g.view(B, L, D, d))
        gm = dm.index_select(0, flat).view(B, L, D)
        sim.masked_fill_(~gm[:, :, None, :], NEG)
        return torch.where(qm[:, None, :], sim.amax(-1), 0.0).sum(-1)
    lib = time_ms(library, iters=3)
    nbytes, flops, uniq = rerank_cost(q, qm, rows, dm, D, d + 4 + 1)
    b_ms, b_by = bound_split_bf16(nbytes, flops)
    log(f"[times] rerank int8 initial rows[{B},{L}] codes[{N},{D},{d}] "
        f"({uniq} distinct candidates), {route} route: wrapper {ms:.4f} ms "
        f"(launch with the query packed once {kern:.4f} ms, wrapper back "
        f"to back {b2b:.4f} ms), plain {plain:.3f} ms, library {lib:.3f} "
        f"ms, split bf16 bound {b_ms:.4f} ms ({b_by}: the {uniq} distinct "
        f"candidates' codes, scales and mask bytes once), wrapper at "
        f"{100 * b_ms / ms:.1f}% and launch at {100 * b_ms / kern:.1f}% of "
        "it")
    log_bounds("rerank int8 initial", ms, nbytes, flops)
    entries.append(dict(
        name="maxsim_rerank_int8", route="cuda",
        source="src/repro_torch/csrc/maxsim_rerank.cu",
        replaces="src/repro/kernels/maxsim/maxsim.py:312",
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib, kernel_ms=kern, b2b_ms=b2b,
        shape=f"rows[{B},{L}] codes[{N},{D},{d}]"))
    return entries


# ---------------------------------------------------------------------------

def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pages", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32,
                    help="queries per search call")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the frontend phase's arrivals and query "
                         "cuts and of the training phase's batches")
    args = ap.parse_args()
    t_start = time.perf_counter()

    # 1. device
    check(torch.cuda.is_available(), "no CUDA device: this smoke run needs "
          "one GPU")
    src = Path(__file__).resolve().parent / "src"
    check((src / "repro_torch" / "csrc").is_dir(),
          f"{src / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(src))
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi gave no name and power limit")
    log(smi[0])                         # "<name>, <power limit>", verbatim
    log(f"[device] {torch.cuda.get_device_name(0)} (capability "
        f"{torch.cuda.get_device_capability(0)}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 2. build
    from repro_torch.kernels import build
    secs = build.build_all()
    for name, out in build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  [{name}] {line.strip()}")
    for name in build.SIGNATURES:
        build.library(name)
    log(f"[build] {len(build.SIGNATURES)} CUDA libraries built in "
        f"{secs:.1f}s (sm_90a, one nvcc per source in parallel)")
    for name in ("maxsim_scan", "maxsim_scan_db", "maxsim_rerank"):
        n_hgmma = hgmma_count(name)
        check(n_hgmma > 0, f"the {name} library's SASS holds no HGMMA "
              "(wgmma)")
        log(f"[build] {name} library: {n_hgmma} HGMMA (wgmma) instructions "
            "in its SASS (cuobjdump -sass)")

    # 3. kernels
    errs = check_kernels(args, dev)
    errs.update(check_int8_and_db_kernels(args, dev))
    bag = embed_bag_phase(args, dev)

    # 4. main paths
    main_res = main_path(args, dev)
    int8_res = main_path_int8(args, dev, main_res)
    filt_res = filtered_path(args, dev, main_res)
    route_res = routed_path(args, dev, main_res)
    cost_res = cost_model_path(args, main_res, int8_res, route_res)
    dtype_res = dtype_path(args, dev, main_res)
    dup_res = duplicate_routed_path(args, dev, main_res)
    ingest_res = ingest_path(args, dev, main_res)
    fe_res = frontend_path(args, dev, main_res)
    mrl_res = matryoshka_quickstart_path(args, dev, main_res)
    tier_res = tiered_path(args, dev, main_res)
    mesh_res = mesh_path(args, dev, main_res, int8_res, filt_res, route_res)

    # 5. times
    entries = kernel_times(args, dev, main_res)
    entries += kernel_times_int8_and_db(args, dev, main_res, int8_res)

    # 4l, 4m, 4n, 4o and 4k after the kernel times: their training loads
    # and profiled steps stay out of them. 4l's, 4m's and 4n's timed parts
    # and 4o come first, the profiles last, so that no profiled step comes
    # before a 4l, 4m, 4n or 4o timing
    lm_res = lm_path(args, dev)
    recsys_res = recsys_path(args, dev)
    gnn_res = gnn_path(args, dev)
    cells_res = cells_path(args, dev, recsys_res, gnn_res)
    train_res = train_path(args, dev)
    shard_res = shard_path(args, dev, lm_res)
    part_res = part_path(args, dev)
    dry_res = dry_path(args, dev)
    audit_res = audit_path(args, dev)
    lm_res["f"] = lm_profiles(args, dev, lm_res)
    recsys_res["f"] = recsys_profiles(args, dev, recsys_res)
    gnn_res["f"] = gnn_profiles(args, dev, gnn_res)
    c8 = int8_res["counts"]
    cm = mesh_res["counts"]
    # the main paths' launches, each path driven with the counts zeroed
    # before it and read after: phase 4 (float), 4b (int8), 4p (mesh)
    # (and 4r's partitioned index cell, one pooling launch a position)
    launches = {"maxsim_scan": main_res["counts"]["maxsim_scan"]
                + cm["maxsim_scan"],
                "maxsim_rerank": main_res["counts"]["maxsim_rerank"]
                + cm["maxsim_rerank"],
                "pool": main_res["counts"]["pooling"] + cm["pooling"]
                + part_res["b"]["index"]["launches"],
                "maxsim_scan_db": c8["maxsim_scan_db"] + cm["maxsim_scan_db"],
                "maxsim_scan_int8": c8["maxsim_scan_int8"]
                + cm["maxsim_scan_int8"],
                "maxsim_rerank_int8": c8["maxsim_rerank_int8"]
                + cm["maxsim_rerank_int8"]}
    errs_by = dict(errs, pool=errs["pooling"])
    for e in entries:
        e["launches"] = launches[e["name"]]
        e["max_abs_err"] = errs_by[e["name"]]
    entries.append(bag["entry"])
    log(f"[times] embed_bag: {bag['entry']['launches']} launches over the "
        "op's own runs (one per shape)")
    used = [{k: v for k, v in res["counts"].items() if v}
            for res in (filt_res, route_res)]
    log(f"[times] filtered path launches: {used[0]}; routed path launches: "
        f"{used[1]}")
    for k in ("maxsim_scan", "maxsim_rerank"):
        log(f"[times] {k}: {launches[k]} launches on the main path; per "
            "query batch " + ", ".join(
                f"{n}-stage {res['per_call'][k]:.0f}"
                for n, res in main_res["results"].items()))
    log(f"[times] pool: {launches['pool']} launches on the main path, one "
        "per 256-page index batch (4r's partitioned index cell: "
        f"{part_res['b']['index']['launches']}, one a position and call)")
    log(f"[times] int8 path launches: maxsim_scan_db {c8['maxsim_scan_db']}"
        f" (one per chunked scan), maxsim_scan_int8 "
        f"{c8['maxsim_scan_int8']} (one per scan_topk chunk), "
        f"maxsim_rerank_int8 {c8['maxsim_rerank_int8']}, maxsim_rerank "
        f"(bf16) {c8['maxsim_rerank']}")
    log(f"[times] mesh path (4p) launches: "
        f"{ {k: v for k, v in cm.items() if v} }; added to the kernels "
        "line")
    for n, res in main_res["results"].items():
        log(f"[summary] {n}-stage @ {args.pages} pages: kernel QPS "
            f"{res['qps']:.1f}, plain QPS {res['plain_qps']:.1f}, "
            f"ndcg@10={res['metrics']['ndcg@10']:.4f} "
            f"recall@10={res['metrics']['recall@10']:.4f}")
    for name, res in int8_res["results"].items():
        log(f"[summary] {name} @ {args.pages} pages: kernel QPS "
            f"{res['qps']:.1f}, plain QPS {res['plain_qps']:.1f}, "
            f"ndcg@10={res['metrics']['ndcg@10']:.4f} "
            f"recall@10={res['metrics']['recall@10']:.4f}")
    for name, res in filt_res["results"].items():
        log(f"[summary] filtered 2-stage {name} ({res['n_match']} pages): "
            f"kernel QPS {res['qps']:.1f}, plain QPS {res['plain_qps']:.1f}, "
            f"ndcg@10={res['metrics']['ndcg@10']:.4f}")
    for n, res in dtype_res.items():
        log(f"[summary] {n}-stage Stage.dtype=bfloat16: kernel QPS "
            f"{res['qps']:.1f}, plain QPS {res['plain_qps']:.1f}, "
            f"ndcg@10={res['metrics']['ndcg@10']:.4f}")
    log(f"[summary] duplicate pages: routed full probe == exhaustive ids, "
        f"{dup_res['pairs']} tied page/copy pairs")
    for n_probe, res in route_res["results"].items():
        log(f"[summary] routed 2-stage n_probe={n_probe}: kernel QPS "
            f"{res['qps']:.1f}, recall@10 vs exhaustive "
            f"{res['recall_vs_ex']:.4f}, "
            f"ndcg@10={res['metrics']['ndcg@10']:.4f} "
            f"recall@10={res['metrics']['recall@10']:.4f}")
    log(f"[summary] fused ingest {ingest_res['pps']:.1f} pages/s, "
        f"index + add_pages {ingest_res['pps_legacy']:.1f} pages/s "
        "(batches of 64, bit-for-bit equal segments)")
    for part, x in fe_res["res"].items():
        log(f"[summary] frontend ({part}) offered {offered(x)}, "
            f"served {x['qps']:.1f} req/s: p50 "
            f"{x['p50']:.3f} ms, p99 {x['p99']:.3f} ms, padded-row share "
            f"{x['padded_share']:.4f}, {x['dispatches']} dispatches")
    log(f"[summary] MRL32 2-stage: kernel QPS {mrl_res['qps']:.1f}, plain "
        f"QPS {mrl_res['plain_qps']:.1f}, "
        f"ndcg@10={mrl_res['metrics']['ndcg@10']:.4f}")
    t = tier_res
    log(f"[summary] tiered, {t['segments']} segments of "
        f"{t['seg_mb']:.1f} MB ({t['total_gb']:.3f} GB), budget 3: overlap "
        f"{t['overlap']['qps']:.1f} QPS, sync {t['sync']['qps']:.1f} QPS "
        f"(ratio {t['overlap_ratio']:.3f}), resident "
        f"{t['resident_qps']:.1f} QPS; {t['overlap']['promotions']} "
        f"promotions over {t['batches']} batches; promotion "
        f"{t['overlap']['promote_gbs']:.2f} GB/s, h2d pinned "
        f"{t['h2d']['pinned']:.2f} / pageable {t['h2d']['pageable']:.2f} "
        f"GB/s; hot scope {t['hot']['qps']:.1f} QPS (resident "
        f"{t['hot']['resident_qps']:.1f}); {t['degraded']['n']} degraded "
        f"results; snapshot write {t['snapshot']['write_gbs']:.2f} GB/s, "
        f"restore {t['snapshot']['restore_gbs']:.2f} GB/s; int8 "
        f"{t['int8']['qps']:.1f} QPS; engine peak {t['peak_mb']:.1f} MB")
    mq = mesh_res["qps"]
    log(f"[summary] mesh (4p), {MESH_SHARDS} shards time-sliced on one "
        "card: not a multi-card figure. QPS one device / 1-position mesh / "
        f"{MESH_SHARDS} shards: " + "; ".join(
            f"{n}-stage {main_res['results'][n]['qps']:.1f} / "
            f"{mq[(1, n)]:.1f} / {mq[(MESH_SHARDS, n)]:.1f}"
            for n in main_res["results"]) + "; " + "; ".join(
            f"{k} {v:.1f}" for (s_, k), v in mq.items()
            if s_ == MESH_SHARDS and not isinstance(k, int))
        + "; per-shard rerank " + f"{mesh_res['kernel_ms']['rerank'][0]:.3f}"
        f" ms x {MESH_SHARDS} vs one device "
        f"{mesh_res['kernel_ms']['rerank'][1]:.3f} ms; search peak "
        + ", ".join(f"{k} {v:.1f} MB" for k, v in mesh_res["peak_mb"].items())
        + f"; phase 4p {mesh_res['seconds']:.1f}s")
    new_launches = {name: {k: v for k, v in res["counts"].items() if v}
                    for name, res in (("ingest", ingest_res),
                                      ("frontend", fe_res),
                                      ("mrl", mrl_res),
                                      ("tiered", tier_res),
                                      ("train", train_res),
                                      ("recsys", recsys_res),
                                      ("gnn", gnn_res),
                                      ("cells", cells_res),
                                      ("audit", audit_res))}
    tr = train_res["res"]
    log(f"[summary] train (ColPali, 16 layers, batch 16, f32): "
        f"{tr['b']['ms']:.1f} ms/step, {tr['b']['pages_s']:.1f} pages/s, "
        f"{tr['b']['tflops']:.2f} TFLOP/s of {tr['b']['flops']:.4e} FLOPs, "
        f"peak {tr['b']['peak_gb']:.2f} GB; card vs CPU (2 layers) loss rel "
        f"err {tr['a']['loss_rel']:.2e}, grad max abs err "
        f"{tr['a']['grad_abs']:.2e}; checkpoint {tr['c']['gb']:.3f} GB "
        f"write {tr['c']['write_gbs']:.2f} / restore "
        f"{tr['c']['restore_gbs']:.2f} GB/s, resumed loss rel err "
        f"{tr['c']['rel']:.2e}; encode {tr['d']['pages_s']:.1f} pages/s, "
        f"2-stage recall@10={tr['d']['metrics']['recall@10']:.4f} "
        f"ndcg@10={tr['d']['metrics']['ndcg@10']:.4f}")
    lm = lm_res
    log(f"[summary] lm (a) card vs CPU, 5 archs reduced: loss rel err <= "
        f"{max(x['loss_rel'] for x in lm['a'].values()):.2e}, grad max abs "
        f"err {max(x['grad_abs'] for x in lm['a'].values()):.2e}; (b) "
        f"minicpm-2b bf16 batch 8 x 128: {lm['b']['ms']:.1f} ms/step, "
        f"{lm['b']['tokens_s']:.1f} tokens/s, {lm['b']['tflops']:.2f} "
        f"TFLOP/s, peak {lm['b']['peak_gb']:.2f} GB; at seq 4096 batch "
        f"{lm['f']['b_4k']['batch']}: {lm['f']['b_4k']['ms']:.1f} ms/step, "
        f"{lm['f']['b_4k']['tflops']:.2f} TFLOP/s, peak "
        f"{lm['f']['b_4k']['peak_gb']:.2f} GB; (c) gemma3-4b f32 decode vs "
        f"forward "
        f"max abs err {lm['c']['err_first']:.2e} / {lm['c']['err_last']:.2e}"
        f", bf16 prefill {lm['c']['prefill_ms']:.1f} ms, decode "
        f"{lm['c']['decode_ms']:.2f} ms/step, cache {lm['c']['cache_mb']:.1f}"
        f" MB; (d) granite-moe step dense {lm['d']['dense_ms']:.1f} / ragged "
        f"{lm['d']['ragged_ms']:.1f} ms, loss rel err "
        f"{lm['d']['loss_rel']:.2e}; (e) resumed loss rel err "
        f"{lm['e']['rel']:.2e}")
    rs = recsys_res
    log(f"[summary] recsys (a) card vs CPU, 4 archs at the tests' size: loss "
        f"rel err <= {max(x['loss_rel'] for x in rs['a'].values()):.2e}, "
        f"grad max abs err {max(x['grad_abs'] for x in rs['a'].values()):.2e}"
        "; " + "; ".join(
            f"{a}: serve p50/p99 {r['p50']:.3f}/{r['p99']:.3f} ms, bulk "
            f"{r['bulk_rows_s']:.0f} rows/s, retrieval 1-stage "
            f"{r['ret']['1-stage']['qps']:.1f} / 2-stage "
            f"{r['ret']['2-stage']['qps']:.1f} QPS (recall@100 "
            f"{r['ret']['2-stage']['recall']:.2f}), train batch "
            f"{r['train']['batch']} {r['train']['ms']:.1f} ms/step "
            f"{r['train']['tflops']:.2f} TFLOP/s peak "
            f"{r['train']['peak_gb']:.2f} GB, busy "
            f"{100 * rs['f'][a]['busy']:.1f}%"
            for a, r in rs.items() if a not in ("a", "f", "counts", "seconds"))
        + f"; phase 4m {rs['seconds']:.1f}s")
    log(gnn_summary(gnn_res))
    log(cells_summary(cells_res))
    sq = shard_res
    log(f"[summary] shard (4q), 4 positions on one card (not a multi-card "
        f"figure): collectives bit for bit the CPU mesh ({sq['a']['n']} "
        f"bodies); equiformer-v2 full width vertex cut S=4 "
        f"{sq['b']['vertex cut S=4']['ms']:.1f} ms/step, minibatch dp=tp=2 "
        f"{sq['b']['minibatch dp=tp=2']['ms']:.1f} ms/step; granite-moe "
        f"ragged_ep tp=4 {sq['c']['ms']:.1f} ms/step (one device ragged "
        f"{sq['c']['one_ms']:.1f}), {100 * sq['c']['dropped']:.3f}% dropped; "
        f"dlrm lookup_shardmap {sq['d']['ms']:.3f} ms (whole "
        f"{sq['d']['one_ms']:.3f}); dcn-v2 two-level 2-stage "
        f"{sq['e']['ms']:.2f} ms (one-level {sq['e']['one_ms']:.2f}); "
        f"psum_compressed {sq['f']['gbs']:.1f} GB/s; phase 4q "
        f"{sq['seconds']:.1f}s")
    pa, pb = part_res["a"], part_res["b"]
    log("[summary] partitioned (4r), 4 positions on one card (not a "
        "multi-card figure): card vs CPU mesh loss rel err <= "
        f"{max(pa[k]['loss_rel'] for k in ('minicpm', 'zero_seq', 'molecule', 'colpali')):.2e}"
        f", decode logits {pa['decode']:.2e}, pooled {pa['index']:.2e}; "
        + "; ".join(f"{k} {pb[k]['ms']:.1f} ms/step (one device "
                    f"{pb[k]['one_ms']:.1f})"
                    for k in ("minicpm", "granite", "colpali", "molecule"))
        + f"; gemma3-4b prefill {pb['gemma3']['prefill_ms']:.1f} ms (one "
        f"device {pb['gemma3']['prefill_one_ms']:.1f}), decode "
        f"{pb['gemma3']['decode_ms']:.2f} ms/step (one device "
        f"{pb['gemma3']['decode_one_ms']:.2f}); index "
        f"{pb['index']['ms']:.1f} ms (one device {pb['index']['one_ms']:.1f})"
        f"; minicpm loss gap {pb['minicpm']['gap']:.2e}; phase 4r "
        f"{part_res['seconds']:.1f}s")
    da, db = dry_res["a"], dry_res["b"]
    log(f"[summary] dry run (4s): 101/101 cells ok on the 16 x 16 meta mesh,"
        f" {da['n_fit']} fit one position of this card, device memory "
        f"unchanged, {da['seconds']:.1f}s; held bytes vs the card's growth: "
        + ", ".join(f"{a} {100 * r['err']:.3f}%" for a, r in db.items())
        + "; peak a position (dry) / one step on the card: " + ", ".join(
            f"{a} {r['peak_dry'] / 1e9:.2f} / {r['peak_card'] / 1e9:.2f} GB"
            for a, r in db.items())
        + f"; phase 4s {dry_res['seconds']:.1f}s")
    ar = audit_res["rows"]
    log(f"[summary] audit (4t): AST layer {audit_res['n_ast']} findings, 0 "
        f"gated; {len(ar)} op-audit scenarios with their kernels, 0 gated "
        f"D1-D4, sync-free under set_sync_debug_mode('error'): "
        f"{', '.join(audit_res['sync_free'])}; largest op output / "
        "max_memory_allocated growth: " + ", ".join(
            f"{n} {r['max_live_bytes'] / 2**20:.2f} / "
            f"{r['grown'] / 2**20:.2f} MiB" for n, r in ar.items())
        + f"; ids equal the CPU's ({sum(r['swaps'] for r in ar.values())} "
        f"tie swaps); phase 4t {audit_res['seconds']:.1f}s")
    f4 = mesh_res["f"]
    log("[summary] cost model (phase 4; ms a batch measured / bytes at "
        f"{HBM_TBS} TB/s): " + "; ".join(
            f"{k} {c['ratio']:.2f}x fewer madds, {c['ms']:.3f} / "
            f"{c['model_ms']:.4f} ms" for k, c in cost_res.items())
        + "; mesh (4p f) rerank_overcommit 1 / 2 / 8: QPS "
        + " / ".join(f"{f4[oc]['qps']:.1f}" for oc in (1, 2, 8))
        + ", rows dropping candidates " + " / ".join(
            str(f4[oc]["n_drop"]) for oc in (1, 2, 8))
        + ", ndcg@10 " + " / ".join(f"{f4[oc]['ndcg']:.4f}"
                                    for oc in (1, 2, 8))
        + ", per-shard rerank " + " / ".join(
            f"{f4[oc]['rerank_ms']:.3f}" for oc in (1, 2, 8))
        + f" ms; place=False 2-stage {f4['unplaced 2']:.1f} QPS")
    log(f"[summary] launches of the new phases: {new_launches}")
    log(f"[summary] total {time.perf_counter() - t_start:.1f}s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {k: e[k] for k in keys + ("kernel_ms", "b2b_ms") if k in e}
        for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

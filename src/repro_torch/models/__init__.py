"""The paper's late-interaction encoders (``repro.models``' retriever
family): ``late_interaction.ColXEncoder``."""

"""The recsys family (``repro.models.recsys``' port): ``embedding`` (the
big/small table layout, ``take_rows``, ``lookup``, ``bag_lookup``) and
``nets`` (``RecsysModel``: dcn-v2, autoint, bert4rec, dlrm-mlperf; the
train, serve and candidate-search steps)."""

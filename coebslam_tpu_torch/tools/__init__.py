"""Data tools: the TUM-format replica written to disk
(``make_tum_replica``), the vocabulary trainer (``train_vocab``) and the
walker detector's trainer (``train_detector``), each run as ``python3 -m
coebslam_tpu_torch.tools.<name> ...``."""

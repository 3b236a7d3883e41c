"""Data tools: the TUM-format replica written to disk
(``make_tum_replica``) and the vocabulary trainer (``train_vocab``), each
run as ``python3 -m coebslam_tpu_torch.tools.<name> ...``."""

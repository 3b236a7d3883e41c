"""The fleet benchmark of the PyTorch/CUDA SLAM port.

``benchmark/run.py`` is the entry point. This package holds the yardstick:
the traffic generator and its renderer (``traffic``), the plain reference
that decides ``correct`` (``reference``), the work counts and the peaks
(``counts``), the reduction of traces to per-layer numbers (``trace``),
the statistics (``stats``), one session process (``session``) and the
fleet around it (``fleet``). Nothing here imports JAX or the JAX package;
``reference``, ``traffic``, ``counts`` and ``stats`` import nothing of the
port either.
"""

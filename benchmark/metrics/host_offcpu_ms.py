"""Host ms per frame in which a session's thread was inside its frame's
``step`` span but not on a CPU (wall minus the thread's CPU time: waiting
for a core, or blocked), in a run that carries the program's window
(``slambench.program``)."""


def read(run):
    prog = getattr(run, "program", None)
    if not prog or not prog["steps"] or not run.frames:
        return None
    return prog["offcpu_ns"] / 1e6 / run.frames

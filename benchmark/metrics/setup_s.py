"""From the start of the process to the start signal: spawning, CUDA
start-up, vocabulary, weights, rendering and warm-up."""


def read(run):
    return run.setup_s

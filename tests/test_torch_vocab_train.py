"""Parity of the port's vocabulary training and .npz persistence with the
JAX package: the same descriptors and seed give array-equal trees and
weights, and either package's ``save`` loads in the other."""
import numpy as np
import pytest

from coebslam_tpu.slam import vocabulary as jvoc
from coebslam_tpu_torch.slam import vocabulary as tvoc


def _descriptors(seed, n, n_centres=40, flip=0.12):
    """[n, 32] uint8 descriptors around random centres (each bit flipped
    with probability ``flip``), so the clustering has structure."""
    rng = np.random.RandomState(seed)
    centres = rng.randint(0, 2, (n_centres, 256)).astype(np.uint8)
    bits = centres[rng.randint(0, n_centres, n)]
    bits ^= (rng.rand(n, 256) < flip).astype(np.uint8)
    return np.packbits(bits, axis=1, bitorder="little")


def _assert_voc_equal(a, b):
    for name in ("node_desc", "children", "word_id", "word_weight",
                 "node_level"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert (a.depth, a.branching) == (b.depth, b.branching)


@pytest.mark.parametrize("seed,n,branching,depth", [
    (0, 3000, 8, 3), (1, 1500, 10, 2), (2, 600, 4, 4), (3, 40, 8, 3)])
def test_train_array_equal(seed, n, branching, depth):
    desc = _descriptors(seed, n)
    j = jvoc.train(desc, branching=branching, depth=depth, seed=seed)
    t = tvoc.train(desc, branching=branching, depth=depth, seed=seed)
    _assert_voc_equal(j, t)
    assert t.n_words > 1
    w_j, g_j = jvoc.transform_host(j, desc)
    w_t, g_t = tvoc.transform_host(t, desc)
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_array_equal(g_t, g_j)


def test_save_load_both_ways(tmp_path):
    desc = _descriptors(4, 2000)
    t = tvoc.train(desc, branching=8, depth=3, seed=0)
    tvoc.save(str(tmp_path / "port.npz"), t)
    _assert_voc_equal(jvoc.load(str(tmp_path / "port.npz")), t)
    jvoc.save(str(tmp_path / "jax.npz"), jvoc.Vocabulary(*t))
    _assert_voc_equal(tvoc.load(str(tmp_path / "jax.npz")), t)
    _assert_voc_equal(tvoc.load(str(tmp_path / "port.npz")), t)

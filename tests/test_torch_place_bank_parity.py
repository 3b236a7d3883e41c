"""The place bank of [19] on shared inputs: the port's maintenance program
held to the JAX package's on the same frames, scene vocabulary and RANSAC
draws (``rt_loop_scenes.py``, ``BANK_LIMITS``, maintenance every frame).

Each package trains its own scene vocabulary from its own renderer's
frames (the renderers part by one grey level on a few pixels), and a torch
generator cannot reproduce ``jax.random``. Here the port gets the JAX
package's rendered frames (numpy), its trained vocabulary (carried field
by field into the port's ``Vocabulary``) and its draws (through
``Maintainer.step(sampler=)``), and the two sessions are compared at every
dispatch: keyframes made, bank insertions, the BoW candidates and their
scores (the event log), the 3D-3D RANSAC's inliers, the accepted closure
(its pair and its frame), the poses after the pose graph, and the bank
relocalization's frame and candidate.

- ``test_closing_dispatch_matches`` (fast tier): the dispatch that closes
  (a)'s loop through the bank, alone: both Maintainers on the JAX
  session's state as it stood before it (``tests/data/rt_bank_closing.npz``,
  written by ``python3 cpu_reference.py jax rt-bank-snapshot``);
  decisions and counters equal, poses within 1e-4, points 1e-3, BoW 1e-6
  (``tests/test_torch_maintenance.py``'s rules).
- ``TestSharedInputs`` (slow: two sessions of each package, ~4-5 min
  each): every dispatch's decisions equal, poses within 1e-4, event scores
  within 1e-4; the revisit gap and the relocalization's median error
  within 10 % of the JAX package's.
"""
import functools
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from coebslam_tpu import config as jcfg
from coebslam_tpu.ops import extractor as jex
from coebslam_tpu.slam import maintenance as jm, realtime as jrt, \
    vocabulary as jvoc
from coebslam_tpu.utils import synthetic as jsyn
from coebslam_tpu_torch import config as tcfg
from coebslam_tpu_torch.slam import maintenance as tm, realtime as trt, \
    vocabulary as tvoc
from host_bow_scenes import scene_vocabulary
from rt_loop_scenes import (BANK_LIMITS, BANK_VOCAB, bank_loop_summary,
                            bank_reloc_summary, bank_vocab_frames,
                            circuit_config, run_bank_reloc, run_realtime)
from test_loop_e2e import (DEPTH_BIAS, N_CIRCUIT, N_OVERLAP, circuit_poses,
                           six_wall_room)
from test_torch_maintenance import _assert_states_match, _dispatch_sampler

torch.set_num_threads(4)

SNAPSHOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "rt_bank_closing.npz")
JCFG = circuit_config(jcfg)
GAIN_TOL = 0.10              # the gap and the median error, relative


@functools.lru_cache(maxsize=None)
def shared_inputs():
    """The JAX package's circuit frames (grey, depth x DEPTH_BIAS, numpy),
    ground-truth centres, its scene vocabulary and a black frame."""
    planes = six_wall_room()
    poses = circuit_poses(N_CIRCUIT + N_OVERLAP)
    render = jax.jit(lambda p: jsyn.render(JCFG.camera, p, planes)[:2])
    frames = [(np.asarray(g), np.asarray(d) * DEPTH_BIAS)
              for g, d in map(render, poses)]
    gt = np.asarray([-np.asarray(p.R).T @ np.asarray(p.t) for p in poses])
    ex = jax.jit(lambda g: jex.extract(g, JCFG.orb))
    descs = []
    for i in bank_vocab_frames(N_CIRCUIT):
        f = ex(frames[i][0])
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = scene_vocabulary(jvoc, descs, **BANK_VOCAB)
    black = (np.zeros_like(frames[0][0]), np.zeros_like(frames[0][1]))
    return frames, gt, voc, black


def port_vocabulary(voc):
    """The JAX package's Vocabulary carried into the port's, field by
    field."""
    return tvoc.Vocabulary(*[x if isinstance(x, int) else np.asarray(x)
                             for x in voc])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _record(st, ms):
    """One dispatch's outcome, as numpy."""
    g = lambda x: np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                             else x)
    out = {k: g(getattr(ms, k)) for k in (
        "n_events", "n_loops", "n_reloc", "n_bank_loops", "n_bank_reloc",
        "bow_next", "bank_next", "bank_lid", "loop_log")}
    out.update(n_kf=g(st.n_kf), ok=g(st.track.ok), R=g(st.track.R),
               t=g(st.track.t), kf_t=g(st.kf_t), kf_lid=g(st.kf_lid),
               reuse_lid=g(st.reuse_lid), seed_ttl=g(st.seed_ttl))
    return out


def assert_events_match(ev_t, ev_j):
    """Event logs (``report()["loop_events"]``): every field equal but the
    BoW score, within 1e-4."""
    assert len(ev_t) == len(ev_j)
    for a, b in zip(ev_t, ev_j):
        assert {k: v for k, v in a.items() if k != "score"} \
            == {k: v for k, v in b.items() if k != "score"}, (a, b)
        assert abs(a["score"] - b["score"]) <= 1e-4, (a, b)


def run_session(pkg, scene, voc=True, keep=None):
    """(a) ``scene="loop"`` or (b) ``"reloc"`` on the shared inputs through
    ``pkg``'s RealtimeSlam (the port with the JAX draws). Returns the
    ``finish()`` result and every dispatch's ``_record``. ``keep(args)``
    sees each dispatch's arguments before it runs."""
    frames, _, jvoc_, black = shared_inputs()
    if pkg == "jax":
        lim = jrt.RTLimits(**BANK_LIMITS)
        rt = jrt.RealtimeSlam(JCFG, lim, vocabulary=jvoc_ if voc else None,
                              maintain_every=1)
    else:
        tc = tcfg.config_from_dict(__import__("dataclasses").asdict(JCFG))
        rt = trt.RealtimeSlam(tc, trt.RTLimits(**BANK_LIMITS), device="cpu",
                              vocabulary=port_vocabulary(jvoc_) if voc
                              else None, maintain_every=1)
    rec = []
    if voc:
        step = rt.maint.step

        def recorded(st, ms, seed, **kw):
            if keep is not None:
                keep((st, ms, seed, kw))
            if pkg == "port":
                kw["sampler"] = _dispatch_sampler(int(seed))
            out = step(st, ms, seed, **kw)
            rec.append(_record(*out))
            return out

        rt.maint.step = recorded
    if scene == "loop":
        res = run_realtime(rt, frames)
    else:
        res = run_bank_reloc(rt, frames, black, N_CIRCUIT // 2)
    return res, rec


def save_closing_snapshot(path=SNAPSHOT):
    """Run (a) through the JAX package and write the state before the
    dispatch that applies the bank closure (its RTState and MaintState
    leaves by path, its seed) and the scene vocabulary to ``path``."""
    seen = []
    res, rec = run_session("jax", "loop", keep=lambda a: seen.append(
        (_np(a[0]), _np(a[1]), int(a[2]))))
    k = next(i for i, r in enumerate(rec) if int(r["n_bank_loops"]) > 0)
    st, ms, seed = seen[k]
    voc = shared_inputs()[2]
    arrays = {f"st{jax.tree_util.keystr(p)}": np.asarray(x) for p, x in
              jax.tree_util.tree_flatten_with_path(st)[0]}
    arrays.update({f"ms{jax.tree_util.keystr(p)}": np.asarray(x) for p, x
                   in jax.tree_util.tree_flatten_with_path(ms)[0]})
    arrays.update({f"voc.{f}": np.asarray(getattr(voc, f))
                   for f in jvoc.Vocabulary._fields})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, seed=np.int64(seed), dispatch=np.int64(k),
                        **arrays)
    return k


def load_closing_snapshot(path=SNAPSHOT):
    """(RTState, MaintState) as numpy pytrees of the JAX package, the seed,
    the dispatch's index and the vocabulary, from ``save_closing_snapshot``."""
    z = dict(np.load(path))
    voc = jvoc.Vocabulary(*[
        int(z[f"voc.{f}"]) if z[f"voc.{f}"].ndim == 0 else z[f"voc.{f}"]
        for f in jvoc.Vocabulary._fields])
    lim = jrt.RTLimits(**BANK_LIMITS)
    maint = jm.Maintainer(JCFG, lim, voc)

    def rebuild(prefix, template):
        paths, tree = jax.tree_util.tree_flatten_with_path(template)
        return jax.tree_util.tree_unflatten(tree, [
            z[f"{prefix}{jax.tree_util.keystr(p)}"] for p, _ in paths])

    st = rebuild("st", jrt.init_state(JCFG, lim))
    ms = rebuild("ms", maint.init_state())
    return st, ms, int(z["seed"]), int(z["dispatch"]), voc, maint


def test_closing_dispatch_matches():
    """The dispatch that closes (a)'s loop through the bank, on the JAX
    session's state before it: the same closure (pair, inliers), the same
    pose graph result and bank, with the reference's draws."""
    st, ms, seed, k, voc, maint = load_closing_snapshot()
    js, jms = maint.step(jax.tree.map(jnp.asarray, st),
                         jax.tree.map(jnp.asarray, ms), np.uint32(seed))
    lim = trt.RTLimits(**BANK_LIMITS)
    tc = tcfg.config_from_dict(__import__("dataclasses").asdict(JCFG))
    tmaint = tm.Maintainer(tc, lim, port_vocabulary(voc), device="cpu")
    ts, tms = tmaint.step(trt.state_from_numpy(st, "cpu"),
                          tm.maint_state_from_numpy(ms, "cpu"), seed,
                          n_kf=int(st.n_kf), bow_next=int(ms.bow_next),
                          sampler=_dispatch_sampler(seed))
    _assert_states_match(js, jms, ts, tms, lim)
    assert int(ms.n_bank_loops) == 0 and int(tms.n_bank_loops) == 1
    ev = tmaint.report(tms)["loop_events"]
    assert_events_match(ev, maint.report(jms)["loop_events"])
    last = ev[-1]
    assert last["applied"] and last["lid"] - last["cand_lid"] > lim.max_kf
    moved = np.abs(ts.kf_t.numpy() - st.kf_t).max()
    assert moved > 1e-3                   # the pose graph moved the ring


def _assert_records_match(rj, rp):
    """Every dispatch: decisions and counters equal, poses within 1e-4,
    the event log within 1e-4 (its scores)."""
    assert len(rj) == len(rp)
    for i, (a, b) in enumerate(zip(rj, rp)):
        for k in a:
            if k in ("R", "t", "kf_t", "loop_log"):
                np.testing.assert_allclose(b[k], a[k], atol=1e-4,
                                           err_msg=f"dispatch {i} {k}")
            else:
                np.testing.assert_array_equal(b[k], a[k],
                                              err_msg=f"dispatch {i} {k}")


def _first(rec, key):
    return next((i for i, r in enumerate(rec) if int(r[key]) > 0), None)


@pytest.mark.slow
class TestSharedInputs:
    """Both packages over [19]'s whole scenes on the shared inputs."""

    def test_bank_loop(self):
        _, gt, _, _ = shared_inputs()
        rj, recj = run_session("jax", "loop")
        rp, recp = run_session("port", "loop")
        _assert_records_match(recj, recp)
        assert_events_match(rp["loop_events"], rj["loop_events"])
        k = _first(recj, "n_bank_loops")
        assert k is not None and _first(recp, "n_bank_loops") == k
        odo = run_session("jax", "loop", voc=False)[0]
        from coebslam_tpu.eval import ate
        sj = bank_loop_summary(rj, odo, gt, N_CIRCUIT, N_OVERLAP, ate)
        sp = bank_loop_summary(rp, odo, gt, N_CIRCUIT, N_OVERLAP, ate)
        assert (sp["n_kf"], sp["bank_entries"], sp["applied_gaps"]) == \
            (sj["n_kf"], sj["bank_entries"], sj["applied_gaps"])
        assert abs(sp["gap_m"] - sj["gap_m"]) <= GAIN_TOL * sj["gap_m"], \
            (sp["gap_m"], sj["gap_m"])

    def test_bank_relocalization(self):
        rj, recj = run_session("jax", "reloc")
        rp, recp = run_session("port", "reloc")
        _assert_records_match(recj, recp)
        k = _first(recj, "n_bank_reloc")
        assert k is not None and _first(recp, "n_bank_reloc") == k
        assert int(recp[k]["reuse_lid"]) == int(recj[k]["reuse_lid"])
        sj, sp = bank_reloc_summary(rj), bank_reloc_summary(rp)
        assert (sp["n_bank_reloc"], sp["revisit_ok"]) == \
            (sj["n_bank_reloc"], sj["revisit_ok"])
        assert abs(sp["median_err_m"] - sj["median_err_m"]) \
            <= GAIN_TOL * sj["median_err_m"], \
            (sp["median_err_m"], sj["median_err_m"])

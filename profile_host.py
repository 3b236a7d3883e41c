"""The host-orchestrated System on the card, alone: ``chip_smoke.py`` [13].

Run from the repository root:  python3 profile_host.py [--json PATH]

Builds the FAST kernel, renders the first N_HOST frames of the 400-frame
TUM replica on the card and drives ``System(SystemConfig())`` over them
twice: synchronous mapping (as [13]) and realtime mode
(``enable_realtime(finalize_batch=8)``: the tracker finalizes eight frames
per transfer, one frame behind, and the mapper advances one stage per
frame). For each it prints what [13] prints (frames OK and lost, ATE,
keyframes, live points, local BAs, culls, FAST launches, host syncs per
frame with their sites, fps with the card drained at the end, the
mapper's stage ms and peak device memory) and the host ms per frame
(median and 90th percentile of ``System.metrics``). ``--json PATH`` also
writes the numbers as JSON.
"""
import json
import os
import sys

import numpy as np

from chip_smoke import (N_HOST, card, driver_phase, host_summary,
                        replica_host_frames, run_host)


def main():
    import torch
    if not torch.cuda.is_available():
        print("profile_host: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from coebslam_tpu_torch.config import SystemConfig
    from coebslam_tpu_torch.eval import ate
    from coebslam_tpu_torch.ops import fast_cuda
    from coebslam_tpu_torch.slam.system import System
    from coebslam_tpu_torch.utils import replica

    card_line = card()
    print(card_line, flush=True)
    fast_cuda.load(fast_cuda.build())
    frames, gt = replica_host_frames(replica, N_HOST, "cuda")
    out = {"card": card_line}
    for mode in ("synchronous", "realtime"):
        sysm = System(SystemConfig())
        if mode == "realtime":
            sysm.enable_realtime(finalize_batch=8)
        states, launches, syncs, sites, secs, mem = driver_phase(
            torch, fast_cuda, lambda s: run_host(s, frames), sysm)
        hs = host_summary(sysm, states, [f[0] for f in frames], gt, ate)
        stage_ms = dict(sysm.mapper.stage_ms)
        wall = np.asarray([f.wall_ms for f in sysm.metrics.frames])
        r = dict(hs, fast_launches=launches, host_syncs=syncs,
                 syncs_per_frame=syncs / hs["n"], sync_sites=sites,
                 seconds=secs, fps=hs["n"] / secs, peak_mib=mem,
                 stage_ms=stage_ms,
                 frame_ms_median=float(np.median(wall)),
                 frame_ms_p90=float(np.percentile(wall, 90)))
        out[mode] = r
        print(f"{mode}: " + json.dumps(r), flush=True)
    if "--json" in sys.argv:
        path = sys.argv[sys.argv.index("--json") + 1]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()

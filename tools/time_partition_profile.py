#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s kernel count on the partition phase's slices.

    python3 tools/time_partition_profile.py [slice ...]

For each named slice of ``chip_smoke.partition_slices()`` (by default the
three with the most launches: ``env_asr_chain``, ``subtractive_voice``,
``polyblep_cascade``), superblocked and block by block, the wall seconds
``chip_smoke.count_kernels`` (torch.profiler with the CPU and CUDA
activities) takes over the partition phase's window, beside the same count
with the CUDA activity alone, and the two counts. Builds the kernels
first. Prints one line a slice and partition, and the card's name and
power limit.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICES = ("env_asr_chain", "subtractive_voice", "polyblep_cascade")
PER_BLOCK_WINDOW = 16  # blocks, the window the per-block count had


def count_cuda_only(torch, run):
    """``chip_smoke.count_kernels`` with the CUDA activity alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0) or None


def main(names):
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import knaster_tpu_torch as kt
    from knaster_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        sys.exit("time_partition_profile: needs a CUDA card")
    dev = torch.device("cuda", 0)
    for n in build.build_all():
        build.load_library(n)
    slices = cs.partition_slices()
    for name in names:
        bs, outs, frames, setup, _, _, _ = slices[name]
        for chunk in (cs.CHUNK, 1):
            opts = kt.AudioProcessorOptions(block_size=bs, render_chunk_blocks=chunk)
            blocks = cs.PROFILE_BLOCKS if chunk == cs.CHUNK else PER_BLOCK_WINDOW
            n_prof = min(frames, blocks * bs)
            res = []
            for label, count in (("cpu+cuda", lambda r: cs.count_kernels(torch, r)),
                                 ("cuda", lambda r: count_cuda_only(torch, r))):
                g, proc = kt.AudioProcessor.new(0, outs, opts, device=dev)
                setup(kt, g)
                proc._ensure_compiled()
                t0 = time.perf_counter()
                n = count(lambda: proc.render(frames=n_prof, fetch=False))
                res.append(f"{label} {n} launches in {time.perf_counter() - t0:.2f} s")
            print(f"{name} render_chunk_blocks={chunk}, {n_prof} frames: " + "; ".join(res),
                  flush=True)
    print(cs.card_name_and_limit())


if __name__ == "__main__":
    main(sys.argv[1:] or SLICES)

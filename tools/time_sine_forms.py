#!/usr/bin/env python3
"""Time the hand sine kernel's event-free form against the forms it was chosen over.

    python3 tools/time_sine_forms.py

``csrc/sine_bank.cu`` reads ``sin_quant`` from a shared-memory table of its
4097 first-quadrant values and lets a warp whose gains are all zero skip
its loop (it advances its phases at once). Besides that form the script
builds the three others from copies of ``csrc/`` under
``build/sine_forms/<form>/``, each made by exact substitutions in
``sine_bank.cu`` (``FORMS``; each must match as often as stated): the
table read swapped for the polynomial (no table, no dynamic shared memory),
the skip turned off, and both. It loads each form's library in place of the
kernel's and times ``sine_bank.launch`` event-free at V = 131,072 and
B in {64, 1024} (the launches captured in a CUDA graph,
``chip_smoke.time_graph``), the forms in turns, twice, the faster run of
each kept, from three states: ``tools/time_bank_kernel.py``'s (every
voice triggered once, four blocks rendered: most voices still in attack),
``chip_smoke.py``'s slice (every voice sustained, every ramp flat) and that
state with the first half of the bank stopped. Every form's state must be
bit-equal to the kernel's and its mix within ``chip_smoke.mix_tolerance``.
It prints one line a (state, B), then the card's ``name, power.limit``.
Needs a CUDA card.
"""

import ctypes
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

V = 131072
BLOCKS = (64, 1024)
CAPACITY = 4096  # tools/time_bank_kernel.py's event_capacity
POLY = (("    fill_sin_table(sin_tab);\n", "", 1),
        ("sin_quant_table(phase, sin_tab)", "sin_quant(phase)", 2),
        ("const size_t dyn = EVENTFUL ? 0 : kSinTable * sizeof(float);",
         "const size_t dyn = 0;", 1))
LOOP = (("    const bool quiet =\n        fast &&", "    const bool quiet =\n        false &&", 1),)
# form name -> substitutions (old, new, occurrences) in csrc/sine_bank.cu
FORMS = {"table, quiet warps skipped (the kernel)": (),
         "polynomial, quiet warps skipped": POLY,
         "table, every warp looped": LOOP,
         "polynomial, every warp looped": POLY + LOOP}


def build_forms(build):
    """{form: library path}: every form's sine_bank.cu built at once."""
    running = []
    for k, (form, subs) in enumerate(FORMS.items()):
        out = os.path.join(HERE, "build", "sine_forms", str(k))
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(build.CSRC, out)
        src = os.path.join(out, "sine_bank.cu")
        text = open(src).read()
        for old, new, n in subs:
            if text.count(old) != n:
                sys.exit(f"form {form!r}: {old!r} occurs {text.count(old)} times, not {n}")
            text = text.replace(old, new)
        open(src, "w").write(text)
        so = os.path.join(out, "sine_bank.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, src]
        running.append((form, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
    paths = {}
    for form, so, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"form {form!r} failed to build:\n{log}")
        paths[form] = so
    return paths


def load(build, mod, path):
    """``path``'s library, declared as ``build.load_library`` declares it."""
    lib = ctypes.CDLL(path)
    fn = lib.ktt_sine_bank
    fn.restype = ctypes.c_int
    fn.argtypes = mod.ARGTYPES
    lib.ktt_error_string.restype = ctypes.c_char_p
    lib.ktt_error_string.argtypes = [ctypes.c_int]
    return lib


def tool_state(cs, ktt, np, torch, dev):
    """tools/time_bank_kernel.py's state: every voice triggered once, then
    four event-free blocks."""
    bank = cs.make_bank(ktt, np, "sine", V, CAPACITY)
    ctx = ktt.AudioCtx(cs.SR, 64, torch.float32)
    state = bank.init(ctx, device=dev)
    trig = bank.trig_index("t_restart")
    for base in range(0, V, CAPACITY):
        ev = bank.node_events_from_lists(
            [(0, v, trig, 1, 0.0) for v in range(base, base + CAPACITY)])
        state, _ = bank.process(ctx, state, events=ev)
    for _ in range(4):
        state, _ = bank.process(ctx, state)
    return bank, state


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    import knaster_tpu_torch as ktt
    from knaster_tpu_torch.kernels import build
    from knaster_tpu_torch.kernels import sine_bank as mod

    if not torch.cuda.is_available():
        sys.exit("time_sine_forms: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi failed"
    libs = {form: load(build, mod, path) for form, path in build_forms(build).items()}
    kernel_form = next(iter(FORMS))
    bank_t, st_t = tool_state(cs, ktt, np, torch, dev)
    bank_s, st_s, *_ = cs.phase_slice(torch, np, ktt, dev, "sine", card, True)
    half = torch.arange(V, device=dev) < V // 2
    st_h = dict(st_s, stage=torch.where(half, 0.0, st_s["stage"]))
    for label, bank, state in (("time_bank_kernel state", bank_t, st_t),
                               ("slice state", bank_s, st_s),
                               ("slice state, half stopped", bank_s, st_h)):
        for B in BLOCKS:
            ops, _ = bank.kernel_operands(ktt.AudioCtx(cs.SR, B, torch.float32), state, None)
            outs = mod.empty_outputs(ops["phase"], B)
            best, want = {}, None
            for form in list(FORMS) + list(FORMS)[::-1]:
                build._libs["sine_bank"] = libs[form]
                mod.launch(outs, **ops)
                got = [x.clone() for x in outs]
                ms = cs.time_graph(torch, lambda: mod.launch(outs, **ops),
                                   200 if B == 64 else 30)
                if want is None:
                    want = got
                for a, b in zip(got[2:], want[2:]):
                    if not torch.equal(cs.bits(a), cs.bits(b)):
                        sys.exit(f"form {form!r}, {label}, B={B}: state differs "
                                 f"from {kernel_form!r}")
                err = float((got[0] - want[0]).abs().max())
                if err > cs.mix_tolerance(V, float(want[0].abs().max())):
                    sys.exit(f"form {form!r}, {label}, B={B}: mix differs by {err}")
                best[form] = min(best.get(form, ms), ms)
            build._libs.pop("sine_bank")
            print(f"sine forms V={V} B={B} event-free, {label}: "
                  + "; ".join(f"{form} {ms:.4f} ms" for form, ms in best.items()), flush=True)
    print(card)


if __name__ == "__main__":
    main()

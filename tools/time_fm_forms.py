#!/usr/bin/env python3
"""Time the FM bank and FM cascade kernels against the forms they were chosen over.

    python3 tools/time_fm_forms.py [fm_bank] [fm_cascade]

Each kernel's source is the form kept. Besides it the script builds the
forms it was chosen over from copies of ``csrc/`` under
``build/fm_forms/<kernel>/<n>/``, each made by exact substitutions in the
kernel's source (``BANK_FORMS``, ``CASCADE_FORMS``; each must match as
often as stated), loads each form's library in place of the kernel's and
times it in turns with the kept form, twice, the faster run of each kept
(both kernels, or those named):

- ``csrc/fm_bank.cu`` at V = 131,072 and B in {64, 1024}, event-free and
  eventful (the first ``event_capacity`` events of ``chip_smoke.py``'s
  schedule), the launches captured in a CUDA graph
  (``chip_smoke.time_graph``), from two states: every voice triggered once
  and four blocks rendered (``chip_smoke.sounding_state``: attacks and
  releases) and the same with every voice stopped (the slice's final
  state); the forms: the polynomial for the sine table in eventful
  blocks, and 64 registers (``__launch_bounds__(256, 4)``) against none,
  per variant;
- ``csrc/fm_cascade.cu`` at N = 256 and B in {16, 64, 1024, 8192}, in the
  layout ``launch_plan`` picks and forced to one CTA and to clusters of 2,
  4, 8 and 16 (CUDA events over back-to-back launches,
  ``chip_smoke.time_call``); the forms: the CTAs' totals by a cluster
  barrier a stage (the chain kernel's exchange) instead of the look-back,
  the shared three-barrier block scan instead of the one-barrier one, the
  phase words read and written 32 stages at a time instead of one a stage,
  ``__launch_bounds__(1024)``, the 227 KB opt-in only for a one-CTA launch
  that needs more than 48 KB (as the earlier design took it), no sine
  table, and the table wherever it fits.

Every form's state must be bit-equal to the kept form's (the cascade's
block too) and the bank's mix within ``chip_smoke.mix_tolerance``. It
prints one line a (kernel, state or layout, B, variant), then the card's
``name, power.limit``. Needs a CUDA card.
"""

import ctypes
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

V = 131072
CAPACITY = 4096  # tools/time_bank_kernel.py's event_capacity
N = 256  # chip_smoke.CASCADE

POLY = (
    ("  extern __shared__ float sin_tab[];\n  fill_sin_table(sin_tab);\n  if constexpr",
     "  extern __shared__ float sin_tab[];\n  if (!EVENTFUL) fill_sin_table(sin_tab);\n"
     "  if constexpr", 1),
    ("const float mod = sin_quant_table(phm, sin_tab);\n        phm += to_inc(freq * mat<true>",
     "const float mod = sin_quant(phm);\n        phm += to_inc(freq * mat<true>", 1),
    ("const float car = sin_quant_table(phc, sin_tab);\n        phc += to_inc(car_freq * f2pi);"
     "\n        const float s",
     "const float car = sin_quant(phc);\n        phc += to_inc(car_freq * f2pi);"
     "\n        const float s", 1),
    ("const size_t dyn = kSinTable * sizeof(float);",
     "const size_t dyn = EVENTFUL ? 0 : kSinTable * sizeof(float);", 1),
)
BOUNDS = "__launch_bounds__(kThreads, EVENTFUL ? 1 : 4)"
# form name -> substitutions (old, new, occurrences) in csrc/fm_bank.cu
BANK_FORMS = {
    "kept (the sine table; event-free 64 registers, eventful unbounded)": (),
    "eventful: polynomial": POLY,
    "eventful: 64 registers": ((BOUNDS, "__launch_bounds__(kThreads, 4)", 1),),
    "event-free: unbounded": ((BOUNDS, "__launch_bounds__(kThreads, 1)", 1),),
}

BARRIER = '''// exchange: begin
// The CTAs' totals of one stage (cluster layout), as the chain kernel
// exchanges them (csrc/chain_kernel.cu exchange_u32): thread 0 writes the
// total to one of two slots in turn, a cluster barrier, then every thread
// reads every CTA's slot.
constexpr int kExchangeWords = 2;

struct Exchange {
  uint32_t* words;  // kExchangeWords words of this CTA's shared memory

  __device__ void open() {}
  __device__ uint32_t offset(int k, int rank, uint32_t total, uint32_t* all) {
    cg::cluster_group cl = cg::this_cluster();
    uint32_t* slot = words + (k & 1);
    if (threadIdx.x == 0) slot[0] = total;
    cl.sync();
    uint32_t b = 0u, a = 0u;
    for (int r = 0; r < static_cast<int>(cl.num_blocks()); ++r) {
      const uint32_t u = *cl.map_shared_rank(slot, r);
      if (r < rank) b += u;
      a += u;
    }
    *all = a;
    return b;
  }
  __device__ void close() { cg::this_cluster().sync(); }
};
// exchange: end'''

RULE = "static_cast<long long>(N) * chunk >= 2LL * kTable &&"
BATCHED = (
    ("  int buf = 0;\n  for (int k = 0; k < N; ++k) {",
     "  int buf = 0;\n  const int lane = threadIdx.x & 31;\n"
     "  uint32_t ph_lane = 0u, new_lane = 0u;\n  for (int k = 0; k < N; ++k) {", 1),
    ("    const uint32_t ph0 = phases[k];\n",
     "    if ((k & 31) == 0) ph_lane = k + lane < N ? phases[k + lane] : 0u;\n"
     "    const uint32_t ph0 = __shfl_sync(0xffffffffu, ph_lane, k & 31);\n", 1),
    ("    if (rank == last && threadIdx.x == 0) phases[k] = ph0 + all;",
     "    if (lane == (k & 31)) new_lane = ph0 + all;\n"
     "    if (rank == last && threadIdx.x < 32 && ((k & 31) == 31 || k == N - 1) &&\n"
     "        lane <= (k & 31))\n"
     "      phases[(k & ~31) + lane] = new_lane;", 1),
)
# form name -> substitutions in csrc/fm_cascade.cu; "EXCHANGE" replaces the
# text from "// exchange: begin" to "// exchange: end"
CASCADE_FORMS = {
    "kept (look-back, one-barrier scan, the table where N * chunk >= 2 * 16384)": (),
    "cluster barrier": (("EXCHANGE", BARRIER, 1),),
    "three-barrier scan": (("scan_u32(inc, scratch, buf, &total)",
                            "block_scan_u32(inc, scratch, &total)", 1),),
    "phase words 32 stages at a time": BATCHED,
    "__launch_bounds__(1024)": (("__global__ void fm_cascade_kernel(",
                                 "__global__ void __launch_bounds__(1024) fm_cascade_kernel(",
                                 1),),
    "the opt-in only past 48 KB": (
        ("  if (done[cluster][table]) return cudaSuccess;",
         "  if (done[cluster][table] || (smem <= 48 * 1024 && !cluster)) return cudaSuccess;",
         1),
        ("cudaError_t opt_in(bool cluster, bool table) {",
         "cudaError_t opt_in(bool cluster, bool table, int smem) {", 1),
        ("  cudaError_t err = opt_in(cluster > 1, table);",
         "  cudaError_t err = opt_in(cluster > 1, table, smem);", 1),
        ("  cudaError_t err = opt_in(true, true);", "  cudaError_t err = opt_in(true, true, 0);",
         1)),
    "no table": ((RULE, "false &&", 1),),
    "table wherever it fits": ((RULE, "", 1),),
}
LAYOUTS = (None, 1, 2, 4, 8, 16)


def substitute(text, subs, form):
    for old, new, n in subs:
        if old == "EXCHANGE":
            a, b = text.index("// exchange: begin"), text.index("// exchange: end")
            text = text[:a] + new + text[b + len("// exchange: end"):]
            continue
        if text.count(old) != n:
            sys.exit(f"form {form!r}: {old!r} occurs {text.count(old)} times, not {n}")
        text = text.replace(old, new)
    return text


def build_forms(build, kernel, forms):
    """{form: library path}: every form of csrc/<kernel>.cu built at once."""
    running = []
    for k, (form, subs) in enumerate(forms.items()):
        out = os.path.join(HERE, "build", "fm_forms", kernel, str(k))
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(build.CSRC, out)
        src = os.path.join(out, f"{kernel}.cu")
        with open(src) as f:
            text = substitute(f.read(), subs, form)
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(out, f"{kernel}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, src]
        running.append((form, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
    paths = {}
    for form, so, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"form {form!r} failed to build:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        print(f"{kernel} form {form!r}: ptxas {regs}", flush=True)
        paths[form] = so
    return paths


def load(mod, path):
    """``path``'s library, declared as ``build.load_library`` declares it."""
    lib = ctypes.CDLL(path)
    fn = getattr(lib, f"ktt_{mod.KERNEL}")
    fn.restype = ctypes.c_int
    fn.argtypes = mod.ARGTYPES
    lib.ktt_error_string.restype = ctypes.c_char_p
    lib.ktt_error_string.argtypes = [ctypes.c_int]
    if mod.KERNEL == "fm_cascade":
        lib.ktt_fm_cascade_max_cluster.restype = ctypes.c_int
        lib.ktt_fm_cascade_max_cluster.argtypes = [ctypes.POINTER(ctypes.c_int)]
    return lib


def use(build, mod, lib):
    """Make ``mod``'s launches take ``lib``."""
    build._libs[mod.KERNEL] = lib
    if hasattr(mod, "_LIB"):
        mod._LIB[:] = [lib]


def bank_forms(cs, ktt, np, torch, dev, build):
    from knaster_tpu_torch.kernels import fm_bank as mod

    libs = {form: load(mod, path) for form, path in build_forms(build, "fm_bank",
                                                                BANK_FORMS).items()}
    bank = cs.make_bank(ktt, np, "fm", V, CAPACITY)
    sounding = cs.sounding_state(torch, ktt, bank)
    stopped = dict(sounding, stage=torch.zeros_like(sounding["stage"]),
                   t=torch.zeros_like(sounding["t"]))
    for label, state in (("sounding state", sounding), ("every voice stopped", stopped)):
        for B in (64, 1024):
            ctx = ktt.AudioCtx(cs.SR, B, torch.float32)
            sched = cs.schedule(bank, V, B)[0][:CAPACITY]
            for variant, events in (("event-free", None),
                                    ("eventful", bank.node_events_from_lists(sched))):
                ops, _ = bank.kernel_operands(ctx, state, events)
                outs = mod.empty_outputs(ops["phm"], B)
                best, want = {}, None
                for form in list(BANK_FORMS) + list(BANK_FORMS)[::-1]:
                    use(build, mod, libs[form])
                    mod.launch(outs, **ops)
                    got = [x.clone() for x in outs]
                    ms = cs.time_graph(torch, lambda: mod.launch(outs, **ops),
                                       200 if B == 64 else 30)
                    if want is None:
                        want = got
                    for a, b in zip(got[2:], want[2:]):
                        if not torch.equal(cs.bits(a), cs.bits(b)):
                            sys.exit(f"fm_bank form {form!r}, {label}, B={B} {variant}: "
                                     "state differs from the kept form")
                    err = float((got[0] - want[0]).abs().max())
                    if err > cs.mix_tolerance(V, float(want[0].abs().max())):
                        sys.exit(f"fm_bank form {form!r}, {label}, B={B} {variant}: mix "
                                 f"differs by {err}")
                    best[form] = min(best.get(form, ms), ms)
                print(f"fm_bank forms V={V} B={B} {variant}, {label}: "
                      + "; ".join(f"{form} {ms:.4f} ms" for form, ms in best.items()),
                      flush=True)
    build._libs.pop("fm_bank", None)


def cascade_forms(cs, np, torch, dev, build):
    from knaster_tpu_torch.kernels import fm_cascade as mod

    libs = {form: load(mod, path) for form, path in build_forms(build, "fm_cascade",
                                                                CASCADE_FORMS).items()}
    f2pi, scale = cs.stage_consts(np)
    params = torch.tensor(cs.FM_PARAM_SETS[0][1], dtype=torch.float32, device=dev)
    ph0 = cs.u32_near_top(torch, np, N, 0, dev)
    for B in (16, 64, 1024, 8192):
        for C in LAYOUTS:
            best, want = {}, None
            for form in list(CASCADE_FORMS) + list(CASCADE_FORMS)[::-1]:
                use(build, mod, libs[form])
                out = torch.empty((B,), dtype=torch.float32, device=dev)
                ph = ph0.clone()
                ops = dict(params=params, phases=ph, block_size=B, f2pi=f2pi, scale=scale,
                           cluster=C)
                plan = mod.launch(out, **ops)
                got = (out.clone(), ph.clone())
                if want is None:
                    want = got
                if not (torch.equal(cs.bits(got[0]), cs.bits(want[0]))
                        and torch.equal(got[1], want[1])):
                    sys.exit(f"fm_cascade form {form!r} B={B} cluster {C}: differs from "
                             "the kept form")
                ms = cs.time_call(torch, lambda: mod.launch(out, **ops),
                                  50 if B <= 1024 else 20)
                best[form] = min(best.get(form, ms), ms)
            print(f"fm_cascade forms N={N} B={B} "
                  f"{'planned ' if C is None else ''}cluster {plan.cluster} of {plan.chunk}: "
                  + "; ".join(f"{form} {ms:.4f} ms" for form, ms in best.items()), flush=True)
    build._libs.pop("fm_cascade", None)
    mod._LIB.clear()


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    import knaster_tpu_torch as ktt
    from knaster_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        sys.exit("time_fm_forms: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi failed"
    which = sys.argv[1:] or ["fm_cascade", "fm_bank"]
    if "fm_cascade" in which:
        cascade_forms(cs, np, torch, dev, build)
    if "fm_bank" in which:
        bank_forms(cs, ktt, np, torch, dev, build)
    print(card)


if __name__ == "__main__":
    main()

"""The lowering of a voice's torch body to a CUDA body (knaster_tpu_torch/kernels/lower.py).

On the card a voice with no library body and no hand-written source runs
the CUDA body that ``lower_body`` writes from its torch body; nvcc and the
card are not here, so three things are held on the CPU, each over the
voices: the torch-only ``DetunedVoice`` and ``OrganVoice``
(tools/user_voices.py), the library ``SineVoice`` and ``FMVoice``,
``ModalVoice`` at M = 12 (the bell), 17, 32 and 64 modes (strings), and a
test voice whose body does arithmetic on the sample index ``i_f`` and
sets a u32 carry to a constant.

1. The trace is faithful: the lowered program, run op by op in torch by
   this file's interpreter (``_interpret``: each operand cast to the op's
   compute dtype, as the source casts it), carries its state and gives its
   outputs bit-equal to
   the torch body over 8 blocks of B = 64 (eventful and event-free in
   turn, so both traces run), V = 64, triggers and params from numpy's
   ``default_rng``, the sample index a 0-d f32 tensor as the plain bank
   passes it. ModalVoice at 32 and 64 modes runs 2 of those blocks (its
   torch body takes ~2.5 s a block here).
2. The emitted source is right: compiled with the host C++ compiler
   (``-O1 -ffp-contract=off``, no fast math: each product and sum rounds
   on its own, as under nvcc's ``--fmad=false``) behind
   tests/lowered_body_shim.h, run over the same blocks, its carry is
   bit-equal to the torch body's. Its outputs are bit-equal too, but for a
   body that calls sin, cos, exp or tanh: the host libm's and torch's may
   differ by an ulp, so there each output is held within 2^-21 of its
   magnitude (4 ulps). Skipped only where no C++ compiler is found.
3. Refusals by name: a gather, an in-place op, a ``[V, M]`` value, an f64
   value and a Python branch on a traced value each raise a ValueError
   naming the voice and the op, from ``lower_body`` and from the wrapper
   off the CPU.

And the plain bank (``generic_bank_plain``, the CPU reference) gives a body
the sample index as a 0-d f32 tensor, as the lowered body reads ``p.i_f``.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import knaster_tpu_torch as kt
from knaster_tpu_torch.kernels import bank_common as bc
from knaster_tpu_torch.kernels import generic_bank, lower

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import user_voices  # noqa: E402

SR, B, V = 48000, 64, 64
N_BLOCKS = 8
OUT_RTOL = 2.0 ** -21  # 4 ulps: an output through the host libm's sin/cos/exp/tanh

class _IndexVoice(kt.UGen):
    """A test voice: its f32 carry takes arithmetic on the sample index
    (f32 roundings, each op on its own), its u32 carry counts restarts and
    is set to the constant 0 in event-free blocks."""

    inputs, outputs = 0, 1
    params = (kt.pfloat("freq", 440.0), kt.ptrigger("t_restart"))

    def __init__(self):
        self.pdefaults = {"freq": 440.0}

    def name(self):
        return "IndexVoice"

    def kernel_voice(self, ctx):
        k1, k2, sr = 0.1, np.float32(3.3), float(ctx.sample_rate)

        def body(i_f, c, P, T):
            x = c["x"] * np.float32(0.5) + P["freq"] * (i_f * k1 * k2) + i_f / sr
            if T["t_restart"] is None:
                n = torch.zeros_like(c["n"])
            else:
                n = torch.where(T["t_restart"], (c["n"] + 7) & 0xFFFFFFFF, c["n"])
            return {"x": x, "n": n}, (x * (i_f + 1.0),)

        return kt.KernelVoiceSpec(carry={"x": ("f32", 0.0), "n": ("u32", 0)}, body=body,
                                  voice_name=self.name())


VOICES = {
    "detuned": lambda: user_voices.torch_only(user_voices.DetunedVoice()),
    "organ": lambda: user_voices.torch_only(user_voices.OrganVoice()),
    "sine": lambda: kt.SineVoice(),
    "fm": lambda: kt.FMVoice(),
    "modal12": lambda: kt.ModalVoice(kt.ModalResonator.bell(330.0)),
    "modal17": lambda: kt.ModalVoice(kt.ModalResonator.string(330.0, n_modes=17)),
    "modal32": lambda: kt.ModalVoice(kt.ModalResonator.string(330.0, n_modes=32)),
    "modal64": lambda: kt.ModalVoice(kt.ModalResonator.string(330.0, n_modes=64)),
    "index": _IndexVoice,
}
BLOCKS = {"modal32": 2, "modal64": 2}

# per-voice param draws: (low, high) and edge values some voices take
RANGES = {"freq": (20.0, 3000.0), "amp": (0.0, 0.2), "pan": (-1.0, 1.0),
          "detune": (0.99, 1.02), "ratio": (0.5, 4.0), "index": (0.0, 5.0),
          "decay": (0.05, 4.0), "bar2": (0.0, 1.0), "bar3": (0.0, 1.0)}
EDGES = {"freq": (1.0e5, -300.0, 30000.0, 0.0), "decay": (1e-6,), "amp": (0.0,)}


def _lowered_voice(key):
    voice = VOICES[key]()
    bank = kt.FusedVoiceBank(voice, V)
    spec = bank.spec(kt.AudioCtx(SR, B))
    lb = lower.lower_body(spec, bank._float_names, bank._trig_names, voice.outputs)
    return spec, lb


def _inputs(spec, lb, key, seed=5):
    """Per block: params [B, NF, V] f32 and triggers [B, NT, V] bool (None
    in event-free blocks); the initial carry [NC, V] u32 words (the
    voice's initial values, u32 phases near the top of their range)."""
    rng = np.random.default_rng(seed)
    nf, nt, nc, _ = lb.counts
    blocks = []
    for blk in range(BLOCKS.get(key, N_BLOCKS)):
        prm = np.empty((B, nf, V), np.float32)
        for k, name in enumerate(lb.float_names):
            lo, hi = RANGES.get(name, (0.0, 1.0))
            prm[:, k] = rng.uniform(lo, hi, (B, V))
            for j, x in enumerate(EDGES.get(name, ())):
                prm[:, k, j::16] = x
        trig = rng.random((B, nt, V)) < 0.05 if blk % 2 == 0 else None
        blocks.append((prm, trig))
    words = np.empty((nc, V), np.uint32)
    for k, (kind, init) in enumerate(spec.carry.values()):
        words[k] = (rng.integers(2**32 - 2**26, 2**32, V, dtype=np.uint64).astype(np.uint32)
                    if kind == "u32" else np.float32(init).view(np.uint32))
    return blocks, words


def _carry_of(spec, words):
    return {name: (torch.from_numpy(words[k].astype(np.int64)) if kind == "u32"
                   else torch.from_numpy(words[k].view(np.float32).copy()))
            for k, (name, (kind, _)) in enumerate(spec.carry.items())}


def _words_of(spec, carry):
    return np.stack([(bc.i32_of(carry[n]) if kind == "u32"
                      else carry[n].view(torch.int32)).numpy().view(np.uint32)
                     for n, (kind, _) in spec.carry.items()])


def _run_torch(spec, lb, body, blocks, words):
    """``body`` (the torch body or the lowered program) over the blocks:
    [(carry words [NC, V] after the block, outputs [B, C, V])]."""
    carry = _carry_of(spec, words)
    n_out = lb.counts[3]
    res = []
    for prm, trig in blocks:
        outs = np.empty((B, n_out, V), np.float32)
        for i in range(B):
            P = {n: torch.from_numpy(prm[i, k]) for k, n in enumerate(lb.float_names)}
            T = {n: (None if trig is None else torch.from_numpy(trig[i, k]))
                 for k, n in enumerate(lb.trig_names)}
            carry, rows = body(torch.tensor(float(i)), carry, P, T)
            for ch in range(n_out):
                outs[i, ch] = torch.as_tensor(rows[ch]).to(torch.float32).expand(V).numpy()
        res.append((_words_of(spec, carry), outs))
    return res


# --------------------------------------------------------------------------
# the interpreter: the lowered program in torch, op by op as the source
# computes it
# --------------------------------------------------------------------------

def _interpreted(lb):
    """The lowered program as a body (``body(i_f, carry, P, T) -> (carry',
    outs)``): the eventful trace where any trigger is given."""
    lits = {}

    def body(i_f, carry, P, T):
        eventful = any(t is not None for t in T.values())
        return _interpret(lb, lb.programs[eventful], lits, i_f, carry, P, T)

    return body


def _interpret(lb, prog, lits, i_f, carry, P, T):
    env = []

    def val(a, cdt):
        if isinstance(a, lower.Lit):
            if a not in lits:
                lits[a] = torch.tensor(a.value, dtype=a.dtype)
            return lits[a]
        x = env[a]
        return x if x.dtype == cdt else x.to(cdt)

    names = list(carry)
    leaves = {"carry": lambda j: carry[names[j]],
              "param": lambda j: P[lb.float_names[j]],
              "trig": lambda j: T[lb.trig_names[j]],
              "i_f": lambda j: torch.as_tensor(i_f, dtype=torch.float32)}
    for op in prog.ops:
        k = op.op
        if k in leaves:
            env.append(leaves[k](op.args[0]))
        elif k == "const":
            env.append(val(op.args[0], op.dtype))
        else:
            cdts = [torch.bool if k == "where" and j == 0 else op.cdt for j in range(len(op.args))]
            x = _TORCH_OPS[k](op, *(None if a is None else val(a, cdt)
                                    for a, cdt in zip(op.args, cdts)))
            env.append(x if x.dtype == op.dtype else x.to(op.dtype))

    def root(r):
        return val(r, r.dtype if isinstance(r, lower.Lit) else env[r].dtype)

    new = {}
    for name, r, kind in zip(names, prog.carry, lb.carry_kinds):
        x = root(r).expand(carry[name].shape)  # a constant carry is written to every voice
        new[name] = x.long() & 0xFFFFFFFF if kind == "u32" else x
    return new, tuple(root(r).to(torch.float32) for r in prog.outs)


def _clamp(op, x, lo, hi):
    if lo is not None:
        x = torch.where(x < lo, lo, x)
    return x if hi is None else torch.where(hi < x, hi, x)


def _nan_select(pick):
    """torch's CPU minimum/maximum of floats: NaN where either is NaN, as
    the emitted select is."""
    def op(o, a, b):
        r = pick(a, b)
        if not a.is_floating_point():
            return r
        return torch.where(torch.isnan(a) | torch.isnan(b), torch.full_like(r, float("nan")), r)
    return op


# each op in torch over its operands (already in the op's compute dtype), as
# the emitted statement computes it
_TORCH_OPS = {
    "add": lambda op, a, b: a + b, "sub": lambda op, a, b: a - b,
    "mul": lambda op, a, b: a * b, "div": lambda op, a, b: a / b,
    "reciprocal": lambda op, a: torch.reciprocal(a),
    "<": lambda op, a, b: a < b, "<=": lambda op, a, b: a <= b,
    ">": lambda op, a, b: a > b, ">=": lambda op, a, b: a >= b,
    "==": lambda op, a, b: a == b, "!=": lambda op, a, b: a != b,
    "where": lambda op, c, a, b: torch.where(c, a, b),
    "minimum": _nan_select(lambda a, b: torch.where(b < a, b, a)),
    "maximum": _nan_select(lambda a, b: torch.where(a < b, b, a)),
    "clamp": _clamp,
    "and": lambda op, a, b: a & b, "or": lambda op, a, b: a | b,
    "xor": lambda op, a, b: a ^ b, "not": lambda op, a: ~a,
    "shl": lambda op, a, b: torch.bitwise_left_shift(a, b),
    "shr": lambda op, a, b: torch.bitwise_right_shift(a, b),
    "neg": lambda op, a: -a, "abs": lambda op, a: torch.abs(a),
    "floor": lambda op, a: torch.floor(a), "round": lambda op, a: torch.round(a),
    "sin": lambda op, a: torch.sin(a), "cos": lambda op, a: torch.cos(a),
    "exp": lambda op, a: torch.exp(a), "tanh": lambda op, a: torch.tanh(a),
    "sqrt": lambda op, a: torch.sqrt(a),
    "cast": lambda op, a: a.to(op.dtype), "bitcast": lambda op, a: a.view(op.dtype),
}


def _uses_transcendentals(lb):
    """Whether either trace calls sin, cos, exp or tanh, whose host libm's
    and torch's CPU versions may differ by an ulp."""
    return any(op.op in ("sin", "cos", "exp", "tanh") for p in lb.programs.values()
               for op in p.ops)


_REFERENCE = {}


def _reference(key):
    """(spec, lowered, inputs, the torch body's run), once per voice."""
    if key not in _REFERENCE:
        spec, lb = _lowered_voice(key)
        blocks, words = _inputs(spec, lb, key)
        _REFERENCE[key] = (spec, lb, (blocks, words),
                           _run_torch(spec, lb, spec.body, blocks, words))
    return _REFERENCE[key]


@pytest.mark.parametrize("key", list(VOICES))
def test_lowered_program_is_the_torch_body(key):
    spec, lb, (blocks, words), want = _reference(key)
    got = _run_torch(spec, lb, _interpreted(lb), blocks, words)
    for blk, ((cw, ow), (cg, og)) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(cg, cw, err_msg=f"{key} carry, block {blk}")
        np.testing.assert_array_equal(og.view(np.uint32), ow.view(np.uint32),
                                      err_msg=f"{key} outputs, block {blk}")
    # the counts the harness checks, and a body that moves its state
    assert lb.counts[2] == len(spec.carry) and lb.ops_per_sample > 0
    assert not np.array_equal(want[-1][0], words)


def _compiler():
    return next((c for c in (os.environ.get("CXX"), "g++", "c++", "clang++")
                 if c and shutil.which(c)), None)


DRIVER = r"""
#include "lowered_body_shim.h"

%s

template <bool E>
static void run(int V, int B, const float* prm, const unsigned char* trg, uint32_t* carry,
                float* out) {
  constexpr int NF = VoiceBody::NF, NT = VoiceBody::NT, NC = VoiceBody::NC, C = VoiceBody::C;
  const VoiceBody::Consts k{};
  const VoiceBody body(k, nullptr, nullptr);
  for (int v = 0; v < V; ++v) {
    uint32_t c[NC];
    for (int j = 0; j < NC; ++j) c[j] = carry[j * V + v];
    for (int i = 0; i < B; ++i) {
      float row[NF > 0 ? NF : 1];
      for (int j = 0; j < NF; ++j) row[j] = prm[(i * NF + j) * V + v];
      bool t[NT > 0 ? NT : 1];
      for (int j = 0; j < NT; ++j) t[j] = E && trg[(i * NT + j) * V + v] != 0;
      float o[C];
      body.step(k, c, HostParams<E>{row, static_cast<float>(i)}, t, o);
      for (int ch = 0; ch < C; ++ch) out[(i * C + ch) * V + v] = o[ch];
    }
    for (int j = 0; j < NC; ++j) carry[j * V + v] = c[j];
  }
}

extern "C" void lowered_block(int eventful, int V, int B, const float* prm,
                              const unsigned char* trg, uint32_t* carry, float* out) {
  if (eventful) {
    run<true>(V, B, prm, trg, carry, out);
  } else {
    run<false>(V, B, prm, trg, carry, out);
  }
}
"""


@pytest.mark.parametrize("key", list(VOICES))
def test_emitted_source_compiles_to_the_torch_body(key, tmp_path):
    cxx = _compiler()
    if cxx is None:
        pytest.skip("no host C++ compiler (g++, c++, clang++) to build the emitted source")
    spec, lb, (blocks, words), want = _reference(key)
    src = tmp_path / f"lowered_{key}.cpp"
    src.write_text(DRIVER % lb.source)
    so = tmp_path / f"lowered_{key}.so"
    cmd = [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
           "-I", os.path.dirname(os.path.abspath(__file__)), "-o", str(so), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.lowered_block.restype = None
    lib.lowered_block.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    nf, nt, nc, n_out = lb.counts
    carry = np.ascontiguousarray(words.copy())
    exact_outs = not _uses_transcendentals(lb)
    for blk, ((prm, trig), (cw, ow)) in enumerate(zip(blocks, want)):
        t = np.zeros((B, nt, V), np.uint8) if trig is None else trig.astype(np.uint8)
        prm, t = np.ascontiguousarray(prm), np.ascontiguousarray(t)
        out = np.empty((B, n_out, V), np.float32)
        lib.lowered_block(int(trig is not None), V, B, prm.ctypes.data, t.ctypes.data,
                          carry.ctypes.data, out.ctypes.data)
        np.testing.assert_array_equal(carry, cw, err_msg=f"{key} carry, block {blk}")
        if exact_outs:
            np.testing.assert_array_equal(out.view(np.uint32), ow.view(np.uint32),
                                          err_msg=f"{key} outputs, block {blk}")
        else:
            np.testing.assert_allclose(out, ow, rtol=OUT_RTOL, atol=0,
                                       err_msg=f"{key} outputs, block {blk}")


class _Refused(kt.UGen):
    """A one-output voice whose torch body ``body`` the lowering refuses."""

    inputs, outputs = 0, 1
    params = (kt.pfloat("freq", 440.0), kt.ptrigger("t_restart"))

    def __init__(self, body):
        self.pdefaults = {"freq": 440.0}
        self._body = body

    def name(self):
        return "RefusedVoice"

    def kernel_voice(self, ctx):
        return kt.KernelVoiceSpec(carry={"x": ("f32", 0.0)}, body=self._body,
                                  voice_name=self.name())


def _gather(i_f, c, P, T):
    table = torch.arange(4, dtype=torch.float32)
    return {"x": table[(c["x"] * 3.0).long()]}, (c["x"],)


def _inplace(i_f, c, P, T):
    x = c["x"] * 1.0
    x.add_(P["freq"])
    return {"x": x}, (x,)


def _matrix(i_f, c, P, T):
    ratios = torch.tensor([1.0, 2.7, 5.4], dtype=torch.float32)
    theta = P["freq"].unsqueeze(-1) * ratios  # [V, M]
    return {"x": c["x"]}, (theta,)


def _f64(i_f, c, P, T):
    return {"x": (c["x"].double() + 1.0).float()}, (c["x"],)


def _branch(i_f, c, P, T):
    if i_f > 3.0:  # a Python float in the torch harness, a traced value here
        return {"x": c["x"] - 1.0}, (c["x"],)
    return {"x": c["x"]}, (c["x"],)


@pytest.mark.parametrize("body, op", [
    (_gather, "__getitem__"), (_inplace, "add_"), (_matrix, "unsqueeze"),
    (_f64, "double"), (_branch, "__bool__")],
    ids=["gather", "in-place", "V-by-M", "f64", "python-branch"])
def test_a_body_outside_the_op_set_is_refused_by_name(body, op):
    voice = _Refused(body)
    bank = kt.FusedVoiceBank(voice, 16)
    spec = bank.spec(kt.AudioCtx(SR, B))
    with pytest.raises(ValueError, match=f"RefusedVoice: .*`{op}`"):
        lower.lower_body(spec, bank._float_names, bank._trig_names, 1)
    # off the CPU the wrapper raises the same refusal at the launch (before
    # its device check; meta tensors stand in for the card's): it never
    # falls back to the torch body
    ctx = kt.AudioCtx(SR, B)
    ops, _ = bank.kernel_operands(ctx, bank.init(ctx, device="cpu"))
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v) for k, v in ops.items()}
    with pytest.raises(ValueError, match=f"RefusedVoice: .*`{op}`"):
        generic_bank.generic_bank(**meta)


def test_the_plain_bank_passes_the_sample_index_as_f32():
    """generic_bank_plain gives the body ``i_f`` as a 0-d f32 tensor, as the
    lowered body reads ``p.i_f`` and the JAX kernel traces ``i.astype(f32)``:
    arithmetic on it rounds in f32 on both sides."""
    seen = []

    class Probe(_IndexVoice):
        def kernel_voice(self, ctx):
            spec = super().kernel_voice(ctx)
            inner = spec.body

            def body(i_f, c, P, T):
                seen.append((type(i_f), getattr(i_f, "dtype", None), getattr(i_f, "shape", None)))
                return inner(i_f, c, P, T)

            spec.body = body
            return spec

    bank = kt.FusedVoiceBank(Probe(), 8)
    ctx = kt.AudioCtx(SR, B)
    bank.process(ctx, bank.init(ctx, device="cpu"))
    assert len(seen) == B
    assert all(t is torch.Tensor and dt == torch.float32 and tuple(sh) == () for t, dt, sh in seen)

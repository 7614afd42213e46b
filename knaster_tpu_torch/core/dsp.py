"""Port of knaster_tpu/core/dsp.py: the polynomial sine and tan, the affine scans.

IIR filters are linear recurrences ``s[t+1] = M[t] s[t] + c[t]``; a block
evaluates them as a prefix scan over affine maps in log2(B) steps instead
of a per-sample loop. The JAX package has two associations of that scan
(``jax.lax.associative_scan``'s tree for ``process`` and the Hillis-Steele
"lanes" doubling Mosaic needed for the chain kernel), which differ at the
ulp. The port has one: Hillis-Steele doubling with identity fills and the
lanes variants' multiply-add order, for ``process``, for the chain kernel's
plain bodies and, step for step, in ``csrc/chain_kernel.cu``. So the scan
executor and the kernel path agree bit for bit.

The float phase sums of ``SinNumeric`` and ``Phasor`` take a second
association, ``cumsum_base16``: the one ``jnp.cumsum`` takes on XLA's CPU
backend, so that those oscillators reproduce the JAX package's phases (and
its golden renders) bit for bit. It too serves ``process``, the plain
bodies and the kernel alike.

Every function takes leading batch axes with time on the last axis.
Divisions in these helpers and in the UGens built on them divide by tensors
on the operand's device, never by a Python number: torch's CUDA ``div``
multiplies by the reciprocal of a host scalar, which rounds otherwise than
the kernels' IEEE division (``const`` below).
"""

from __future__ import annotations

import numpy as np
import torch

# degree-9 odd minimax polynomial for sin(u) on [-pi/2, pi/2] (the JAX
# package's _SIN9_C): max error 1.2e-7, the f32 rounding floor
SIN9_C = (1.0, -0.16666652, 0.008332964, -0.00019804752, 2.5981028e-06)
HALF_PI = 1.5707963267948966


def const(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d tensor of ``like``'s dtype on its device: divide by
    this, not by the Python number (see the module docstring)."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def recip(x: float, like: torch.Tensor) -> torch.Tensor:
    """``1 / x`` rounded to ``like``'s dtype, as a 0-d tensor on its device:
    XLA rewrites a division by a constant into a multiply by this
    reciprocal, so the port multiplies by it where the JAX package divides
    by a constant that is not a power of two."""
    dt = np.float64 if like.dtype == torch.float64 else np.float32
    return const(float(dt(1.0) / dt(x)), like)


def sin_poly_quadrant(u):
    """sin(u) for u in [-pi/2, pi/2] by the degree-9 minimax polynomial."""
    u2 = u * u
    p = SIN9_C[4] * u2 + SIN9_C[3]
    p = p * u2 + SIN9_C[2]
    p = p * u2 + SIN9_C[1]
    return (p * u2 + SIN9_C[0]) * u


def tan_first_quadrant(x):
    """tan(x) for x in [0, pi/2) as sin(x) / sin(pi/2 - x) with the
    polynomial at f32 (the JAX package's choice for both SVF executors);
    ``torch.tan`` at f64, as ``jnp.tan`` there."""
    if x.dtype == torch.float64:
        return torch.tan(x)
    return sin_poly_quadrant(x) / sin_poly_quadrant(HALF_PI - x)


def _shift(x, s: int, fill: float):
    """``x`` shifted ``s`` lanes right along the last axis, ``fill`` in front."""
    pad = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., : x.shape[-1] - s]], dim=-1)


def cumsum(x):
    """Inclusive prefix sum along the last axis by Hillis-Steele doubling:
    at step s, lane t adds lane t - s (0 in front)."""
    B = x.shape[-1]
    s = 1
    while s < B:
        x = x + _shift(x, s, 0.0)
        s *= 2
    return x


def shift1(x):
    """``x`` one lane right along the last axis, 0 in lane 0 (the closed
    forms' exclusive prefix)."""
    return _shift(x, 1, 0.0)


# the row length of cumsum_base16's blocked scan
SCAN_BASE = 16


def _row_scan(x):
    """Inclusive prefix sum along the last axis, left to right from 0.0:
    ``((0 + x0) + x1) + ...``."""
    acc = x[..., 0] + 0.0
    cols = [acc]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def cumsum_base16(x):
    """Inclusive float prefix sum along the last axis in the association
    ``jnp.cumsum`` takes on XLA's CPU backend, which the JAX package's
    ``SinNumeric`` and ``Phasor`` (and the golden fixtures rendered through
    them) use: XLA lowers the cumsum to a reduce-window and rewrites it as a
    blocked scan of base 16. Rows of 16 (the tail padded with zeros) are
    summed left to right from 0.0, the row totals are scanned the same way,
    recursively, and each row adds the total of the rows before it (0.0 for
    the first). A length of at most 16 is one such row. Bit-equal to
    ``jnp.cumsum`` on XLA:CPU at every length, f32 and f64
    (``tests/test_torch_param_sweep.py``); ``csrc/scan_base16.cuh``
    (the chain kernel's and the EnvAsr kernel's) takes the same steps."""
    n = x.shape[-1]
    if n <= SCAN_BASE:
        return _row_scan(x)
    rows = -(-n // SCAN_BASE)
    pad = rows * SCAN_BASE - n
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    s = _row_scan(x.reshape(x.shape[:-1] + (rows, SCAN_BASE)))
    before = shift1(cumsum_base16(s[..., SCAN_BASE - 1]))
    return (s + before.unsqueeze(-1)).reshape(x.shape)[..., :n]


def affine_scan_1d(a, b, s0):
    """Scalar linear recurrence ``s[t+1] = a[t]*s[t] + b[t]``.

    a, b: ``[..., B]``; s0: ``[...]``. Returns ``(s_pre [..., B], s_final
    [...])`` with ``s_pre[..., t]`` the state before step t."""
    B = a.shape[-1]
    A, C = a, b
    s = 1
    while s < B:
        Al, Cl = _shift(A, s, 1.0), _shift(C, s, 0.0)
        C = A * Cl + C
        A = Al * A
        s *= 2
    s_after = A * s0.unsqueeze(-1) + C
    s_pre = torch.cat([s0.unsqueeze(-1), s_after[..., :-1]], dim=-1)
    return s_pre, s_after[..., -1]


def affine_scan_2x2_rows(m00, m01, m10, m11, c0, c1, s00, s01):
    """The 2-state recurrence ``s[t+1] = M[t] s[t] + c[t]`` with the matrix
    and the vector as six ``[..., B]`` rows; s00, s01: ``[...]``. Returns
    ``(s_pre0, s_pre1, s_final0, s_final1)``."""
    B = m00.shape[-1]
    A00, A01, A10, A11, C0, C1 = m00, m01, m10, m11, c0, c1
    s = 1
    while s < B:
        l00, l01 = _shift(A00, s, 1.0), _shift(A01, s, 0.0)
        l10, l11 = _shift(A10, s, 0.0), _shift(A11, s, 1.0)
        lc0, lc1 = _shift(C0, s, 0.0), _shift(C1, s, 0.0)
        A00, A01, A10, A11, C0, C1 = (
            A00 * l00 + A01 * l10,
            A00 * l01 + A01 * l11,
            A10 * l00 + A11 * l10,
            A10 * l01 + A11 * l11,
            A00 * lc0 + A01 * lc1 + C0,
            A10 * lc0 + A11 * lc1 + C1,
        )
        s *= 2
    x0, x1 = s00.unsqueeze(-1), s01.unsqueeze(-1)
    s_after0 = A00 * x0 + A01 * x1 + C0
    s_after1 = A10 * x0 + A11 * x1 + C1
    s_pre0 = torch.cat([x0, s_after0[..., :-1]], dim=-1)
    s_pre1 = torch.cat([x1, s_after1[..., :-1]], dim=-1)
    return s_pre0, s_pre1, s_after0[..., -1], s_after1[..., -1]


def affine_scan_2d(M, c, s0):
    """``s[t+1] = M[t] @ s[t] + c[t]`` with M ``[..., B, 2, 2]``, c ``[...,
    B, 2]``, s0 ``[..., 2]``: :func:`affine_scan_2x2_rows` on the unpacked
    entries. Returns ``(s_pre [..., B, 2], s_final [..., 2])``."""
    p0, p1, f0, f1 = affine_scan_2x2_rows(
        M[..., 0, 0], M[..., 0, 1], M[..., 1, 0], M[..., 1, 1], c[..., 0], c[..., 1],
        s0[..., 0], s0[..., 1])
    return torch.stack([p0, p1], dim=-1), torch.stack([f0, f1], dim=-1)

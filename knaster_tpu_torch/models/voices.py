"""Port of knaster_tpu/models/voices.py: the ``SineVoice`` declaration.

SineVoice is the reference's ``many_sines`` voice
(knaster/examples/many_sines.rs: EnvAr * (SinWt.wr_mul(amp)) >> Pan2).
Only its parameter table, defaults and envelope times are ported: the fused
sine bank (parallel/fused_bank.py) renders it in one kernel.
"""

from __future__ import annotations

from ..core.ugen import UGen
from ..primitives.params import ParameterKind, pfloat, ptrigger


class SineVoice(UGen):
    """Enveloped, panned sine voice (many_sines.rs parity)."""

    inputs = 0
    outputs = 2
    params = (
        pfloat("freq", 440.0, kind=ParameterKind.FREQUENCY),
        pfloat("amp", 0.0125),
        pfloat("pan", 0.0),
        ptrigger("t_restart"),
        ptrigger("t_release"),
    )

    def __init__(self, freq: float = 440.0, amp: float = 0.0125, pan: float = 0.0,
                 attack: float = 0.01, release: float = 0.1):
        self.pdefaults = {"freq": float(freq), "amp": float(amp), "pan": float(pan)}
        self.attack = float(attack)
        self.release = float(release)

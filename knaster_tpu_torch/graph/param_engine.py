"""Port of knaster_tpu/graph/param_engine.py: sample-accurate, smoothable, schedulable parameters.

Every float parameter is materialized as a per-sample row ``[P, B]`` from
carried ramp state plus the block's scheduled events, so a change scheduled
at frame ``f`` takes effect at sample ``f`` (the reference's
``WrPreciseTiming``, ``WrSmoothParams`` and scheduling, in one mechanism).

Event model (per block):
  float events: (frame, slot, value, kind, smode, sdur, srate)
      kind 0 = set value (immediate, or ramped if the slot has smoothing
               configured), kind 1 = configure smoothing, which freezes any
               in-flight ramp at its current value.
  trigger events: (frame, slot) — a True at exactly that sample.
  int events: (frame, slot, value) — step change from that sample onward.

Ramps are anchored: ``value`` is the ramp's start value and ``elapsed``
counts samples since its anchor frame, so every sample is
``anchor + step * progress`` in one rounding, whatever the block partition.

The events stay on the host as numpy arrays (``events_from_lists``, the
same dict the JAX package builds). The JAX package folds its padded event
tensor in a device loop; here the host walks the valid events in their
order and each applies the same ``where`` arithmetic to its slot on the
device, so padding costs nothing. Trigger and int-set masks are built on
the host and uploaded once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

SMOOTH_NONE = 0
SMOOTH_LINEAR = 1
RATE_AUDIO = 0
RATE_BLOCK = 1

KIND_SET = 0
KIND_SMOOTH_CFG = 1

_FLOAT_KEYS = ("value", "target", "step", "elapsed", "dur", "smode", "sdur", "srate")


def _np_dtype(dtype):
    """The numpy float type of a sample dtype given as torch or numpy."""
    if dtype == torch.float64 or dtype == np.float64:
        return np.float64
    return np.float32


@dataclass
class ParamLayout:
    """Static mapping from (node_id, param_index) to engine slots."""

    # (node_id, param_idx) -> ("float"|"trigger"|"int", slot)
    slots: Dict[Tuple[int, int], Tuple[str, int]] = field(default_factory=dict)
    n_float: int = 0
    n_trig: int = 0
    n_int: int = 0
    # defaults, indexed by slot
    float_defaults: List[float] = field(default_factory=list)
    int_defaults: List[int] = field(default_factory=list)

    def add(self, node_id: int, param_idx: int, ptype: str, default) -> int:
        if ptype == "float":
            slot = self.n_float
            self.n_float += 1
            self.float_defaults.append(float(default))
            self.slots[(node_id, param_idx)] = ("float", slot)
        elif ptype == "trigger":
            slot = self.n_trig
            self.n_trig += 1
            self.slots[(node_id, param_idx)] = ("trigger", slot)
        elif ptype in ("integer", "bool"):
            slot = self.n_int
            self.n_int += 1
            self.int_defaults.append(int(default))
            self.slots[(node_id, param_idx)] = ("int", slot)
        else:
            raise ValueError(ptype)
        return slot

    def lookup(self, node_id: int, param_idx: int) -> Tuple[str, int]:
        return self.slots[(node_id, param_idx)]


def init_state(layout: ParamLayout, dtype=torch.float32, device="cpu") -> Dict[str, torch.Tensor]:
    n = layout.n_float
    fd = torch.tensor(np.asarray(layout.float_defaults, dtype=_np_dtype(dtype)),
                      dtype=dtype, device=device).reshape(n)

    def zi():
        return torch.zeros((n,), dtype=torch.int32, device=device)

    return {
        "value": fd.clone(),
        "target": fd.clone(),
        "step": torch.zeros((n,), dtype=dtype, device=device),
        "elapsed": zi(),
        "dur": zi(),
        "smode": zi(),
        "sdur": zi(),
        "srate": zi(),
        "int_value": torch.tensor(layout.int_defaults, dtype=torch.int32,
                                  device=device).reshape(layout.n_int),
    }


def empty_events_np(capacity: int, dtype=np.float32) -> Dict[str, np.ndarray]:
    """All-padding event arrays (slot == -1 means 'no event')."""
    E = capacity
    zi = np.zeros((E,), dtype=np.int32)
    return {
        "f_frame": zi.copy(),
        "f_slot": np.full((E,), -1, dtype=np.int32),
        "f_value": np.zeros((E,), dtype=_np_dtype(dtype)),
        "f_kind": zi.copy(),
        "f_smode": zi.copy(),
        "f_sdur": zi.copy(),
        "f_srate": zi.copy(),
        "t_frame": zi.copy(),
        "t_slot": np.full((E,), -1, dtype=np.int32),
        "i_frame": zi.copy(),
        "i_slot": np.full((E,), -1, dtype=np.int32),
        "i_value": zi.copy(),
    }


def events_from_lists(
    capacity: int,
    float_events: List[Tuple[int, int, float, int, int, int, int]],
    trig_events: List[Tuple[int, int]],
    int_events: List[Tuple[int, int, int]],
    dtype=np.float32,
) -> Dict[str, np.ndarray]:
    """Pack python event lists into padded numpy arrays.

    ``float_events`` entries: (frame, slot, value, kind, smode, sdur, srate),
    sorted by frame (stable in send order).
    """
    if (
        len(float_events) > capacity
        or len(trig_events) > capacity
        or len(int_events) > capacity
    ):
        raise ValueError(
            f"more than {capacity} events in one block; raise "
            f"AudioProcessorOptions.event_capacity"
        )
    ev = empty_events_np(capacity, dtype)
    for i, (f, s, v, k, m, d, r) in enumerate(sorted(float_events, key=lambda e: e[0])):
        ev["f_frame"][i] = f
        ev["f_slot"][i] = s
        ev["f_value"][i] = v
        ev["f_kind"][i] = k
        ev["f_smode"][i] = m
        ev["f_sdur"][i] = d
        ev["f_srate"][i] = r
    for i, (f, s) in enumerate(trig_events):
        ev["t_frame"][i] = f
        ev["t_slot"][i] = s
    for i, (f, s, v) in enumerate(sorted(int_events, key=lambda e: e[0])):
        ev["i_frame"][i] = f
        ev["i_slot"][i] = s
        ev["i_value"][i] = v
    return ev


class PEngine:
    """Bound parameter engine for a fixed layout (created per compiled graph).
    Block-rate smoothing stairs at block boundaries."""

    def __init__(self, layout: ParamLayout, block_size: int, dtype=torch.float32):
        self.layout = layout
        self.block_size = int(block_size)
        self.dtype = dtype
        self._ramps = {}  # device -> (t [B+1], stair [B+1]) int32

    def _time(self, device):
        """Sample index t in [0, B] and its block-rate stair (0 inside the
        block, B one past its end)."""
        key = str(device)
        got = self._ramps.get(key)
        if got is None:
            B = self.block_size
            t = torch.arange(B + 1, dtype=torch.int32, device=device)
            got = self._ramps[key] = (t, (t // B) * B)
        return got

    def materialize(self, state, events):
        """Returns (pf, pt, pi, pset, new_state): per-sample float/trigger/int
        parameter rows plus the int set-event mask. ``events`` is the numpy
        dict of ``events_from_lists`` (or ``empty_events_np``)."""
        pf, fstate = self._materialize_floats(state, events)
        device = state["value"].device
        pt = self._materialize_triggers(events, device)
        pi, pset, int_value = self._materialize_ints(state, events, device)
        new_state = dict(fstate)
        new_state["int_value"] = int_value
        return pf, pt, pi, pset, new_state

    def materialize_rows_fast(self, state, idx):
        """[len(idx), B] per-sample values for the given float slots (a slice
        or an index tensor), straight from the ramp state — the event-free
        program's param access."""
        B = self.block_size
        t, stair = self._time(state["value"].device)
        anchor = state["value"][idx]
        target = state["target"][idx]
        step = state["step"][idx]
        E = state["elapsed"][idx]
        dur = state["dur"][idx]
        srate = state["srate"][idx]
        ar = E[:, None] + t[None, :B]
        br = E[:, None] + stair[None, :B]
        prog = torch.where((srate == RATE_AUDIO)[:, None], ar, br)
        return torch.where(
            prog >= dur[:, None],
            target[:, None],
            anchor[:, None] + step[:, None] * prog.to(self.dtype),
        )

    def advance_fast(self, state):
        """The carry after one block of event-free ramping, without
        materializing any per-sample row."""
        B = self.block_size
        out = dict(state)
        out["elapsed"] = torch.minimum(state["elapsed"] + B, state["dur"])
        return out

    def _materialize_floats(self, state, events):
        B = self.block_size
        Pf = self.layout.n_float
        dtype = self.dtype
        device = state["value"].device
        if Pf == 0:
            return torch.zeros((0, B), dtype=dtype, device=device), {
                k: state[k] for k in _FLOAT_KEYS
            }
        t, stair = self._time(device)
        anchor = state["value"]
        target = state["target"]
        step = state["step"]
        el0 = state["elapsed"]
        dur0 = state["dur"]
        smode = state["smode"]
        sdur = state["sdur"]
        srate = state["srate"]

        # the base ramp over [0, B] (one past the end for event reads):
        # progress is the absolute sample count since the ramp's anchor
        # frame; a finished ramp snaps to its target
        ar_prog = el0[:, None] + t[None, :]
        br_prog = el0[:, None] + stair[None, :]
        prog = torch.where((srate == RATE_AUDIO)[:, None], ar_prog, br_prog)
        vals = torch.where(
            prog >= dur0[:, None],
            target[:, None],
            anchor[:, None] + step[:, None] * prog.to(dtype),
        )
        el_next = torch.minimum(el0 + B, dur0)
        dur_next = dur0

        valid = [i for i, s in enumerate(events["f_slot"]) if s >= 0]
        if valid:
            anchor, target, step = anchor.clone(), target.clone(), step.clone()
            el_next, dur_next = el_next.clone(), dur_next.clone()
            smode, sdur, srate = smode.clone(), sdur.clone(), srate.clone()
        zero = torch.zeros((), dtype=dtype, device=device)
        for e in valid:
            s = int(events["f_slot"][e])
            f = int(events["f_frame"][e])
            v = torch.tensor(events["f_value"][e], dtype=dtype, device=device)
            row = vals[s].clone()
            c_f = row[f].clone()  # the ramp value at the event frame
            if int(events["f_kind"][e]) == KIND_SMOOTH_CFG:
                # freeze the ramp at its current value, take the new config
                vals[s] = torch.where(t >= f, c_f, row)
                anchor[s] = c_f
                target[s] = c_f
                step[s] = 0
                el_next[s] = 0
                dur_next[s] = 0
                smode[s] = int(events["f_smode"][e])
                sdur[s] = int(events["f_sdur"][e])
                srate[s] = int(events["f_srate"][e])
                continue
            # a set: ramped when the slot has linear smoothing configured,
            # else immediate (a zero-length ramp parked at its target)
            is_ramp = (smode[s] == SMOOTH_LINEAR) & (sdur[s] > 0)
            dur = torch.clamp(sdur[s], min=1)
            stp = (v - c_f) / dur.to(dtype)
            ar_p = torch.minimum(torch.clamp(t - f, min=0), dur)
            br_p = torch.minimum(torch.clamp(stair - f, min=0), dur)
            p = torch.where(srate[s] == RATE_AUDIO, ar_p, br_p)
            ramp_tail = torch.where(p >= dur, v, c_f + stp * p.to(dtype))
            tail = torch.where(is_ramp, ramp_tail, v)
            vals[s] = torch.where(t >= f, tail, row)
            anchor[s] = torch.where(is_ramp, c_f, v)
            target[s] = v
            step[s] = torch.where(is_ramp, stp, zero)
            dur_next[s] = torch.where(is_ramp, dur, 0)
            el_next[s] = torch.where(is_ramp, torch.clamp(dur, max=B - f), 0)

        new_state = {
            "value": anchor,
            "target": target,
            "step": step,
            "elapsed": el_next,
            "dur": dur_next,
            "smode": smode,
            "sdur": sdur,
            "srate": srate,
        }
        return vals[:, :B], new_state

    def _materialize_triggers(self, events, device):
        B = self.block_size
        Pt = self.layout.n_trig
        grid = np.zeros((Pt, B), dtype=np.bool_)
        for s, f in zip(events["t_slot"], events["t_frame"]):
            if s >= 0:
                grid[s, f] = True
        return torch.from_numpy(grid).to(device)

    def _materialize_ints(self, state, events, device):
        B = self.block_size
        Pi = self.layout.n_int
        int_value = state["int_value"]
        setm = np.zeros((Pi, B), dtype=np.bool_)
        vals = int_value[:, None].expand(Pi, B)
        valid = [i for i, s in enumerate(events["i_slot"]) if s >= 0]
        if valid:
            vals = vals.clone()
            int_value = int_value.clone()
        for e in valid:
            s, f, v = (int(events[k][e]) for k in ("i_slot", "i_frame", "i_value"))
            setm[s, f] = True
            vals[s, f:] = v
            int_value[s] = v
        return vals, torch.from_numpy(setm).to(device), int_value

"""Port of knaster_tpu/parallel/voicebank.py: the bank event channel and ramp state.

A bank holds ``n_voices`` copies of one voice. Per-voice control rides a
private event channel: float sets, triggers, smoothing-ramp starts and
active/note-on flags, all sample-accurate per voice. Same-block bursts on
one (param, voice) slot are exact: the host gives each event a per-slot
``round`` (frame order) and the device folds the rounds in order, emitting
one trajectory breakpoint per round (``_apply_events_breakpoints``) that the
kernel folds per sample. The kernel bank keeps the last
``kernel_burst_depth`` events of a deeper burst and warns once.

Float params are ANCHORED linear ramps per (param, voice): ``fvals`` is the
anchor value, ``felapsed`` the integer progress at block start (a set at
frame f writes ``-f``), ``fdur`` the ramp length and ``ftarget`` the value
after it; a sample's value is ``anchor + step * progress`` in one rounding,
so any block partitioning of a render is bit-identical.

This module covers what the fused kernel bank needs: construction, state
init, event packing, packed trigger words, the breakpoint round fold and the
ramp advance. The vmap ``process`` path and its per-sample round fold are
not ported yet, and neither are int params (no voice of the port has one).
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..core.ugen import AudioCtx, UGen


class VoiceBank(UGen):
    """``n_voices`` copies of a voice UGen, mixed to one bus.

    voice:          a UGen with no audio inputs (a generator/voice model).
    n_voices:       number of parallel voices.
    voice_defaults: optional {param_name: np.ndarray[n_voices]} per-voice
                    initial parameter values (e.g. detuned freqs).
    """

    event_capacity = 256
    # kernel banks keep each slot's last D events of a same-block burst
    kernel_burst_depth: Optional[int] = None

    def __init__(
        self,
        voice: UGen,
        n_voices: int,
        voice_defaults: Optional[Dict[str, np.ndarray]] = None,
        event_capacity: int = 256,
    ):
        if voice.inputs != 0:
            raise ValueError("VoiceBank voices must be generators (no audio inputs)")
        if int(n_voices) < 1:
            raise ValueError("n_voices must be >= 1")
        self.voice = voice
        self.n_voices = int(n_voices)
        self.inputs = 0
        self.outputs = voice.outputs
        self.event_capacity = int(event_capacity)
        self.voice_defaults = dict(voice_defaults or {})
        self._float_names = [p.name for p in voice.params if p.ptype == "float"]
        self._trig_names = [p.name for p in voice.params if p.ptype == "trigger"]
        self._int_names = [
            p.name for p in voice.params if p.ptype in ("integer", "bool")
        ]
        if self._int_names:
            raise NotImplementedError(
                "int/bool voice params need the int-set round fold, which "
                "is not ported yet"
            )

    def name(self) -> str:
        return f"VoiceBank[{self.n_voices}x{self.voice.name()}]"

    # ------------------------------------------------------------- indices
    def float_index(self, name: str) -> int:
        return self._float_names.index(name)

    def trig_index(self, name: str) -> int:
        return self._trig_names.index(name)

    # --------------------------------------------------------------- state
    def init(self, ctx: AudioCtx, device):
        """Per-voice ramp state on ``device``: anchored ramps at the voice
        defaults (or ``voice_defaults``), all voices active, none idle."""
        V = self.n_voices
        np_dtype = np.float32 if ctx.dtype == torch.float32 else np.float64
        fvals = np.zeros((len(self._float_names), V), dtype=np_dtype)
        for i, name in enumerate(self._float_names):
            for p in self.voice.params:
                if p.name == name:
                    fvals[i, :] = getattr(self.voice, "pdefaults", {}).get(
                        name, p.default_value()
                    )
            if name in self.voice_defaults:
                fvals[i, :] = np.asarray(self.voice_defaults[name], dtype=np_dtype)
        nf = len(self._float_names)

        def zeros(dtype):
            return torch.zeros((nf, V), dtype=dtype, device=device)

        fvals_t = torch.from_numpy(fvals).to(device)
        return {
            "fvals": fvals_t,
            "ftarget": fvals_t.clone(),
            "fstep": zeros(ctx.dtype),
            "felapsed": zeros(torch.int32),
            "fdur": zeros(torch.int32),
            "fsdur": zeros(torch.int32),
            "ivals": torch.zeros((0, V), dtype=torch.int32, device=device),
            "active": torch.ones((V,), dtype=torch.bool, device=device),
            # per-voice done latch, cleared by a note-on (event kind 5)
            "idle": torch.zeros((V,), dtype=torch.bool, device=device),
        }

    # --------------------------------------------------------------- events
    def empty_node_events(self, dtype=np.float32):
        E = self.event_capacity
        return {
            "frame": np.zeros((E,), np.int32),
            "voice": np.full((E,), -1, np.int32),
            "param": np.zeros((E,), np.int32),
            # kind: 0 float set, 1 trigger, 2 int set, 3 set-active,
            #       4 smoothing config, 5 clear idle latch (note-on)
            "kind": np.zeros((E,), np.int32),
            "value": np.zeros((E,), dtype),
            "round": np.zeros((E,), np.int32),
        }

    def node_events_from_lists(self, events, dtype=np.float32):
        """events: list of (frame, voice, param_idx, kind, value), in order.

        Every float-set / smoothing-config event is kept and assigned a
        per-slot ``round``: float-family events (kinds 0 and 4) on one
        (param, voice) are ordered jointly by frame (list order breaking
        ties — the engine's queue order). Active/idle sets (kinds 3, 5) are
        block-rate flags; the latest-frame event per (kind, voice) wins.
        Triggers keep every event (one per (frame, param, voice)).

        Banks with ``kernel_burst_depth`` = D keep each slot's LAST D
        events; deeper bursts drop their earliest events (a <=1-block
        transient) and the bank warns once. Returns numpy arrays, the same
        dict the JAX package builds."""
        trigs = {}
        dedup = {}  # kinds 3/5 only: latest frame per (kind, voice)
        fam = {}  # (family, param, voice) -> [events], frame-ordered
        for e in events:
            f, v, p, k, val = e
            if k == 1:
                trigs[(f, p, v)] = e
            elif k in (3, 5):
                prev = dedup.get((k, v))
                if prev is None or f >= prev[0]:
                    dedup[(k, v)] = e
            else:
                # kinds 0 and 4 share one round space per slot: a cfg
                # between two sets must fold between them
                key = (0 if k in (0, 4) else 2, p, v)
                fam.setdefault(key, []).append(e)
        flat, rounds = [], []
        for evs in fam.values():
            evs.sort(key=lambda e: e[0])  # stable: list order on ties
            if self.kernel_burst_depth is not None:
                if len(evs) > self.kernel_burst_depth and not getattr(
                    self, "_burst_depth_warned", False
                ):
                    self._burst_depth_warned = True
                    warnings.warn(
                        f"{self.name()}: a (param, voice) slot received "
                        f"{len(evs)} same-block events but "
                        f"kernel_burst_depth={self.kernel_burst_depth}; "
                        "keeping the last "
                        f"{self.kernel_burst_depth} (<=1-block "
                        "transient). Construct the bank with "
                        "kernel_burst_depth>="
                        f"{len(evs)} for exact deep bursts.",
                        stacklevel=3,
                    )
                evs = evs[-self.kernel_burst_depth:]
            for r, e in enumerate(evs):
                flat.append(e)
                rounds.append(r)
        for e in dedup.values():
            flat.append(e)
            rounds.append(0)
        for e in trigs.values():
            flat.append(e)
            rounds.append(0)
        if len(flat) > self.event_capacity:
            raise ValueError(
                f"more than {self.event_capacity} voice events in one block; "
                f"raise VoiceBank(event_capacity=...)"
            )
        ev = self.empty_node_events(dtype)
        for i, (f, v, p, k, val) in enumerate(flat):
            ev["frame"][i] = f
            ev["voice"][i] = v
            ev["param"][i] = p
            ev["kind"][i] = k
            ev["value"][i] = val
            ev["round"][i] = rounds[i]
        return ev

    @staticmethod
    def _events_to(events, device):
        """The event dict's arrays as tensors on ``device`` (one upload per
        array; tensors already there pass through)."""
        return {k: torch.as_tensor(v, device=device) for k, v in events.items()}

    # -------------------------------------------------------------- process
    def _packed_trigs(self, ctx: AudioCtx, events, trig_idx: int):
        """Sample-accurate triggers as ``ceil(B/32)`` 32-bit mask words per
        voice, stacked ``[W, V]`` int32 (the bit pattern of the JAX
        package's u32 words), built from the event tensor in O(E). Word w
        holds frames [32w, 32w+32). Host dedup guarantees one event per
        (frame, param, voice), so adding single bits cannot carry; the sum
        is formed in int64 because torch has no uint32 arithmetic."""
        V = self.n_voices
        W = (ctx.block_size + 31) // 32
        device = events["voice"].device
        voice, kind = events["voice"], events["kind"]
        param, frame = events["param"], events["frame"].long()
        word_idx = frame >> 5
        sel = ((voice >= 0) & (voice < V) & (kind == 1) & (param == trig_idx)
               & (word_idx >= 0) & (word_idx < W))
        v_sel = torch.where(sel, voice.long(), V)
        bit = torch.ones_like(frame) << (frame & 31)
        z = torch.zeros((W, V + 1), dtype=torch.int64, device=device)
        z.index_put_((torch.where(sel, word_idx, 0), v_sel), bit,
                     accumulate=True)
        z = z[:, :V]
        return torch.where(z >= 2**31, z - 2**32, z).to(torch.int32)

    def _apply_events(self, state):
        """The ``events is None`` branch of the JAX ``_apply_events``: an
        event-free block starts from the carried state unchanged. Returns
        (fstate, ivals, active, idle) with fstate = (fvals, ftarget, fstep,
        felapsed, fdur, fsdur)."""
        fstate = (state["fvals"], state["ftarget"], state["fstep"],
                  state["felapsed"], state["fdur"], state["fsdur"])
        return fstate, state["ivals"], state["active"], state["idle"]

    def _apply_events_breakpoints(self, ctx: AudioCtx, state, events):
        """Round fold for kernel banks: sequential same-block burst
        semantics that emit D = ``kernel_burst_depth`` per-round trajectory
        BREAKPOINTS per slot — (v0, step, dur, tgt, frame), each [D, nf, V]
        — for the kernel to fold per sample. A piece is live for
        ``i >= frame``; untouched rounds carry the ``frame = B`` sentinel so
        their select is a no-op. Each piece's ramp anchors at its own event
        frame, so its in-kernel progress is ``i - frame``.

        Scatters go through a padded sacrificial column V: events that are
        invalid or of another kind land there and it is sliced off, so
        duplicate indices only ever occur in that column.

        Returns (fstate, pieces, ivals, active, idle) with fstate the
        post-burst anchored ramp state (set events write
        felapsed = -frame)."""
        V = self.n_voices
        B = ctx.block_size
        dtype = ctx.dtype
        D = int(self.kernel_burst_depth or 1)
        fvals, ftarget = state["fvals"], state["ftarget"]
        fstep, felapsed = state["fstep"], state["felapsed"]
        fdur, fsdur = state["fdur"], state["fsdur"]
        nf = fvals.shape[0]
        device = fvals.device

        voice = events["voice"].long()
        param = events["param"].long()
        kind = events["kind"]
        value = events["value"].to(dtype)
        frame = events["frame"].to(torch.int32)
        rnd = events["round"]
        valid = (voice >= 0) & (voice < V)

        def pad(arr):
            return torch.cat([arr, arr.new_zeros((arr.shape[0], 1))], dim=1)

        def scat(arr, p_sel, v_sel, vals):
            out = pad(arr)
            out.index_put_((p_sel, v_sel), vals.to(arr.dtype))
            return out[:, :V]

        def sel_voice(sel):
            return torch.where(sel, voice, V)

        p_cl = param.clamp(0, nf - 1)
        zero = torch.zeros((), dtype=dtype, device=device)
        pieces = []
        for r in range(D):
            # smoothing config (kind 4): freeze an in-flight ramp at its
            # frame (engine KIND_SMOOTH_CFG)
            sel_c = valid & (kind == 4) & (rnd == r)
            v_c = sel_voice(sel_c)
            fsdur = scat(fsdur, p_cl, v_c, value.to(torch.int32))
            has_cfg = scat(torch.zeros((nf, V), dtype=torch.bool, device=device),
                           p_cl, v_c, sel_c)
            cfg_frame = scat(torch.zeros((nf, V), dtype=torch.int32, device=device),
                             p_cl, v_c, frame)
            ln_c = felapsed + cfg_frame
            cur_c = torch.where(ln_c >= fdur, ftarget,
                                fvals + fstep * ln_c.to(dtype))
            cut = has_cfg & (fdur > ln_c)
            fdur = torch.where(cut, ln_c, fdur)
            ftarget = torch.where(cut, cur_c, ftarget)
            # the cfg's visible piece: hold the frozen value from its frame
            # on (a cfg that doesn't cut changes nothing visible)
            pv0 = torch.where(cut, cur_c, zero)
            pstep = torch.zeros((nf, V), dtype=dtype, device=device)
            pdur = torch.zeros((nf, V), dtype=torch.int32, device=device)
            ptgt = pv0
            pframe = torch.where(cut, cfg_frame, B)
            # float set (kind 0): ramp/jump anchored at the event frame from
            # the current trajectory's value there
            sel_f = valid & (kind == 0) & (rnd == r)
            v_s = sel_voice(sel_f)
            ln_e = pad(felapsed)[p_cl, v_s] + frame
            old_v0 = pad(fvals)[p_cl, v_s]
            old_step = pad(fstep)[p_cl, v_s]
            old_dur = pad(fdur)[p_cl, v_s]
            old_tgt = pad(ftarget)[p_cl, v_s]
            cur = torch.where(ln_e >= old_dur, old_tgt,
                              old_v0 + old_step * ln_e.to(dtype))
            dur = pad(fsdur)[p_cl, v_s]
            ramp = dur > 0
            new_step = torch.where(
                ramp, (value - cur) / dur.clamp(min=1).to(dtype), zero)
            new_v0 = torch.where(ramp, cur, value)
            new_dur = torch.where(ramp, dur, 0)
            fvals = scat(fvals, p_cl, v_s, new_v0)
            ftarget = scat(ftarget, p_cl, v_s, value)
            fstep = scat(fstep, p_cl, v_s, new_step)
            fdur = scat(fdur, p_cl, v_s, new_dur)
            felapsed = scat(felapsed, p_cl, v_s, -frame)
            pv0 = scat(pv0, p_cl, v_s, new_v0)
            pstep = scat(pstep, p_cl, v_s, new_step)
            pdur = scat(pdur, p_cl, v_s, new_dur)
            ptgt = scat(ptgt, p_cl, v_s, value)
            pframe = scat(pframe, p_cl, v_s, frame)
            pieces.append((pv0, pstep, pdur, ptgt, pframe))
        stacked = tuple(torch.stack([p[j] for p in pieces]) for j in range(5))

        def set_flag(flag, k, vals):
            out = torch.cat([flag, flag.new_zeros((1,))])
            out.index_put_((sel_voice(valid & (kind == k)),), vals)
            return out[:V]

        active = set_flag(state["active"], 3, value > 0.5)
        # note-on (kind 5): clear the voice's idle latch
        idle = set_flag(state["idle"], 5,
                        torch.zeros_like(valid))
        fstate = (fvals, ftarget, fstep, felapsed, fdur, fsdur)
        return fstate, stacked, state["ivals"], active, idle

    @staticmethod
    def _advance_ramps(fstate, B):
        """State after one block of per-sample ramping: integer-only — the
        anchor value/step/target never change between events, so any block
        partitioning carries bit-identical state."""
        fvals, ftarget, fstep, felapsed, fdur, fsdur = fstate
        el_next = torch.minimum(felapsed + B, fdur)
        return (fvals, ftarget, fstep, el_next, fdur, fsdur)

"""Port of knaster_tpu/parallel/voicebank.py: ``VoiceBank``, many copies of one voice mixed to one bus.

A bank holds ``n_voices`` copies of one voice. Per-voice control rides a
private event channel: float sets, triggers, int sets, smoothing-ramp
starts and active/note-on flags, all sample-accurate per voice. Same-block
bursts on one (param, voice) slot are exact: the host gives each event a
per-slot ``round`` (frame order) and the device folds the rounds in order.

Float params are ANCHORED linear ramps per (param, voice): ``fvals`` is the
anchor value, ``felapsed`` the integer progress at block start (a set at
frame f writes ``-f``), ``fdur`` the ramp length and ``ftarget`` the value
after it; a sample's value is ``anchor + step * progress`` in one rounding,
so any block partitioning of a render is bit-identical.

Two consumers share this machinery:

* the bank itself (``process``, the JAX package's vmap path): the round
  fold materializes ``[nf, V, B]`` float and ``[ni, V, B]`` int planes
  (``_apply_events_rounds``) and the voice's own ``process`` runs ONCE over
  the voice axis. The port's UGens take leading batch axes, so where the
  JAX package ``vmap``s, the port passes ``[V, ...]`` state and ``[V, B]``
  params; a voice's ``shared_state_keys`` leaves (the same for every
  voice) stay unbatched. The round count bounding the fold is read from the
  host's event arrays before they are uploaded, so no block copies
  anything back from the device;
* the fused kernel banks (``fused_bank.py``, ``generic_bank.py``), which
  take the state, event packing and packed trigger words from here and fold
  D = ``kernel_burst_depth`` trajectory breakpoints per slot in their kernel
  (``_apply_events_breakpoints``), keeping the last D events of a deeper
  burst (the bank warns once).

The bank always computes its idle latch from the voices' done rows, as the
fused banks do (``parallel/pool.py``). The JAX package's single-round
eventful branch (``burst_rounds = False``) is not ported: such a bank
raises by name.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..core.ugen import AudioCtx, UGen, normalize_process_result


class VoiceBank(UGen):
    """``n_voices`` copies of a voice UGen, mixed to one bus.

    voice:          a UGen with no audio inputs (a generator/voice model).
    n_voices:       number of parallel voices.
    voice_defaults: optional {param_name: np.ndarray[n_voices]} per-voice
                    initial parameter values (e.g. detuned freqs, int
                    seeds).
    mix:            'sum' (the mix bus) or 'stack' (outputs =
                    voices * voice.outputs, voice-major, for per-voice
                    post-processing).
    """

    event_capacity = 256
    # exact same-block bursts per (param, voice) through the round fold;
    # the JAX package's single-round branch (False) is not ported
    burst_rounds = True
    # kernel banks keep each slot's last D events of a same-block burst
    kernel_burst_depth: Optional[int] = None
    # from this many voices on, the voices' envelopes keep their per-sample
    # loop (AudioCtx.wide_batch), as in the JAX package: the closed form
    # reassociates, so the switch is part of the result
    WIDE_BATCH_VOICES = 4096
    # voice_defaults arrays are consumed only by init() (per-voice initial
    # fvals/ivals: state data): banks differing only in them share cached
    # renderers
    signature_exclude = ("pdefaults", "voice_defaults", "_burst_depth_warned")

    def __init__(
        self,
        voice: UGen,
        n_voices: int,
        voice_defaults: Optional[Dict[str, np.ndarray]] = None,
        mix: str = "sum",
        event_capacity: int = 256,
    ):
        if voice.inputs != 0:
            raise ValueError("VoiceBank voices must be generators (no audio inputs)")
        if int(n_voices) < 1:
            raise ValueError("n_voices must be >= 1")
        self.voice = voice
        self.n_voices = int(n_voices)
        self.inputs = 0
        self.mix = mix
        if mix == "sum":
            self.outputs = voice.outputs
        elif mix == "stack":
            self.outputs = voice.outputs * self.n_voices
        else:
            raise ValueError("mix must be 'sum' or 'stack'")
        self.event_capacity = int(event_capacity)
        # a block-dependent voice (PluckedVoice's blockwise ring read) makes
        # the bank block-dependent: the compiler keeps it out of uncapped
        # superblocks
        if not getattr(voice, "block_invariant", True):
            self.block_invariant = False
        self.voice_defaults = dict(voice_defaults or {})
        self._float_names = [p.name for p in voice.params if p.ptype == "float"]
        self._trig_names = [p.name for p in voice.params if p.ptype == "trigger"]
        self._int_names = [
            p.name for p in voice.params if p.ptype in ("integer", "bool")
        ]

    def name(self) -> str:
        return f"VoiceBank[{self.n_voices}x{self.voice.name()}]"

    def make_local(self, n_local: int) -> "VoiceBank":
        """A bank of ``n_local`` voices of the same voice, describing one
        mesh shard (``parallel/mesh.py``). It takes no ``voice_defaults``:
        the per-voice defaults live in the full bank's state, which is
        sliced. Subclasses with other constructors override it."""
        return VoiceBank(self.voice, n_local, mix="sum",
                         event_capacity=self.event_capacity)

    def idle_vector(self, state) -> np.ndarray:
        """The per-voice idle latch of ``state`` on the host (one
        device-to-host copy), as ``VoicePool.refresh`` reads it."""
        return state["idle"].cpu().numpy()

    # ------------------------------------------------------------- indices
    def float_index(self, name: str) -> int:
        return self._float_names.index(name)

    def trig_index(self, name: str) -> int:
        return self._trig_names.index(name)

    def int_index(self, name: str) -> int:
        return self._int_names.index(name)

    # --------------------------------------------------------------- state
    def _default_of(self, name: str):
        p = next(p for p in self.voice.params if p.name == name)
        return getattr(self.voice, "pdefaults", {}).get(name, p.default_value())

    def init_ramps(self, ctx: AudioCtx, device):
        """The event channel's per-voice state on ``device``: anchored ramps
        at the voice defaults (or ``voice_defaults``, cast to ``ctx.dtype``),
        int values likewise, all voices active, none idle."""
        V = self.n_voices
        np_dtype = np.float32 if ctx.dtype == torch.float32 else np.float64
        fvals = np.zeros((len(self._float_names), V), dtype=np_dtype)
        for i, name in enumerate(self._float_names):
            fvals[i, :] = self._default_of(name)
            if name in self.voice_defaults:
                fvals[i, :] = np.asarray(self.voice_defaults[name], dtype=np_dtype)
        ivals = np.zeros((len(self._int_names), V), dtype=np.int32)
        for i, name in enumerate(self._int_names):
            ivals[i, :] = int(self._default_of(name))
            if name in self.voice_defaults:
                ivals[i, :] = np.asarray(self.voice_defaults[name], dtype=np.int32)
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
            "ivals": torch.from_numpy(ivals).to(device),
            "active": torch.ones((V,), dtype=torch.bool, device=device),
            # per-voice done latch, cleared by a note-on (event kind 5)
            "idle": torch.zeros((V,), dtype=torch.bool, device=device),
        }

    def init(self, ctx: AudioCtx, device="cpu"):
        """The event channel's state and, under ``"voices"``, the voice's
        state replicated over a leading ``[V]`` axis, except its
        ``shared_state_keys`` leaves, which stay unbatched. A voice may set
        its ``superblock_cap`` in ``init`` (it needs the sample rate): the
        bank carries it."""
        V = self.n_voices
        voice_state = self.voice.init(ctx, device)
        vcap = getattr(self.voice, "superblock_cap", None)
        if vcap is not None:
            mycap = self.superblock_cap
            self.superblock_cap = vcap if mycap is None else min(mycap, vcap)
        shared = set(getattr(self.voice, "shared_state_keys", ()) or ())

        def rep(tree):
            if isinstance(tree, dict):
                return {k: rep(v) for k, v in tree.items()}
            return tree.unsqueeze(0).expand((V,) + tuple(tree.shape)).clone()

        voices = {k: (v if k in shared else rep(v)) for k, v in voice_state.items()}
        return {"voices": voices, **self.init_ramps(ctx, device)}

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

        Int sets (kind 2) get rounds of their own per (param, voice), in
        the same order. Banks with ``kernel_burst_depth`` = D keep each
        slot's LAST D events; deeper bursts drop their earliest events (a
        <=1-block transient) and the bank warns once. Returns numpy arrays,
        the same dict the JAX package builds."""
        self._check_burst_rounds()
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

    # ------------------------------------------------------ the vmap path
    def _check_burst_rounds(self):
        if not self.burst_rounds:
            raise NotImplementedError(
                f"{self.name()}: burst_rounds=False (the JAX package's "
                "single-round eventful branch) is not ported; keep the "
                "default round fold")

    @staticmethod
    def _n_rounds(events) -> int:
        """The rounds the fold must run: the largest ``round`` over the
        valid float-set, int-set and smoothing-config events, plus one (0
        when there are none), read from the host's numpy arrays before the
        upload."""
        kind = np.asarray(events["kind"])
        relevant = (np.asarray(events["voice"]) >= 0) & (
            (kind == 0) | (kind == 2) | (kind == 4))
        return int(np.asarray(events["round"])[relevant].max()) + 1 if relevant.any() else 0

    def _retrigger_ints(self):
        return [getattr(p, "retrigger", False)
                for p in self.voice.params if p.ptype in ("integer", "bool")]

    @staticmethod
    def _trajectory(fvals, ftarget, fstep, felapsed, fdur, t_idx, dtype):
        """[nf, V, B] samples of the anchored ramps: the target once the
        absolute progress ``felapsed + t`` reaches ``fdur``, else anchor +
        step * progress in one rounding."""
        ln = felapsed.unsqueeze(-1) + t_idx
        return torch.where(ln >= fdur.unsqueeze(-1), ftarget.unsqueeze(-1),
                           fvals.unsqueeze(-1) + fstep.unsqueeze(-1) * ln.to(dtype))

    def _apply_events_rounds(self, ctx: AudioCtx, state, events, n_rounds: int):
        """Exact same-block burst semantics (graph-engine parity): fold the
        event tensor round by round, round r holding each slot's r-th event
        in frame order, and build the per-sample planes as it goes.
        ``n_rounds`` is ``_n_rounds`` of the host's events; a block whose
        slots each see at most one event runs one round.

        Per round and slot there is at most ONE float-family event (a set
        or a smoothing config, which share a round space), so ordering is
        the round sequence. A smoothing config freezes the in-flight
        trajectory at its frame (engine KIND_SMOOTH_CFG); a set anchors its
        ramp (or jump) at its frame, starting from the trajectory's value
        there. Int sets apply from their frame; retrigger int params also
        get a per-sample ``<name>_set`` mask that fires at every set.

        Scatters go through a padded sacrificial column V, as in
        ``_apply_events_breakpoints``. Returns (planes_f [nf, V, B] or
        None, fstate, ivals, planes_i [ni, V, B] or None, iset [ni, V, B]
        or None, trig [max(n_trig, 1), V, B], active, idle)."""
        V = self.n_voices
        B = ctx.block_size
        dtype = ctx.dtype
        nf = state["fvals"].shape[0]
        ni = state["ivals"].shape[0]
        n_trig = len(self._trig_names)
        device = state["fvals"].device

        voice = events["voice"].long()
        param = events["param"].long()
        kind = events["kind"]
        value = events["value"].to(dtype)
        frame = events["frame"].to(torch.int32)
        rnd = events["round"]
        valid = (voice >= 0) & (voice < V)
        t_idx = torch.arange(B, dtype=torch.int32, device=device)

        def pad(arr):
            return torch.cat([arr, arr.new_zeros((arr.shape[0], 1))], dim=1)

        def scat(arr, p_sel, v_sel, vals):
            out = pad(arr)
            out.index_put_((p_sel, v_sel), vals.to(arr.dtype))
            return out[:, :V]

        def zeros(n, dt):
            return torch.zeros((n, V), dtype=dt, device=device)

        def sel_voice(sel):
            return torch.where(sel, voice, V)

        fvals, ftarget, fstep = state["fvals"], state["ftarget"], state["fstep"]
        felapsed, fdur, fsdur = state["felapsed"], state["fdur"], state["fsdur"]
        ivals = state["ivals"]
        pf = pi = None
        if nf:
            pf = self._trajectory(fvals, ftarget, fstep, felapsed, fdur, t_idx, dtype)
            p_f = param.clamp(0, nf - 1)
        if ni:
            pi = ivals.unsqueeze(-1).expand(ni, V, B)
            p_i = param.clamp(0, ni - 1)
        for r in range(n_rounds):
            this = valid & (rnd == r)
            if nf:
                # smoothing config (kind 4): freeze the in-flight trajectory
                # at its frame, retargeted at the value reached there
                sel_c = this & (kind == 4)
                v_c = sel_voice(sel_c)
                fsdur = scat(fsdur, p_f, v_c, value.to(torch.int32))
                has_cfg = scat(zeros(nf, torch.bool), p_f, v_c, sel_c)
                cfg_frame = scat(zeros(nf, torch.int32), p_f, v_c, frame)
                ln_c = felapsed + cfg_frame
                cur_c = torch.where(ln_c >= fdur, ftarget,
                                    fvals + fstep * ln_c.to(dtype))
                cut = has_cfg & (fdur > ln_c)
                fdur = torch.where(cut, ln_c, fdur)
                ftarget = torch.where(cut, cur_c, ftarget)
                pf = torch.where(has_cfg.unsqueeze(-1)
                                 & (t_idx >= cfg_frame.unsqueeze(-1)),
                                 cur_c.unsqueeze(-1), pf)
                # float set (kind 0): a jump, or a ramp anchored at the event
                # frame from the trajectory's value there
                sel_f = this & (kind == 0)
                v_s = sel_voice(sel_f)
                ln_e = pad(felapsed)[p_f, v_s] + frame
                cur = torch.where(ln_e >= pad(fdur)[p_f, v_s], pad(ftarget)[p_f, v_s],
                                  pad(fvals)[p_f, v_s]
                                  + pad(fstep)[p_f, v_s] * ln_e.to(dtype))
                dur = pad(fsdur)[p_f, v_s]
                ramp = dur > 0
                new_step = torch.where(ramp, (value - cur) / dur.clamp(min=1).to(dtype),
                                       torch.zeros((), dtype=dtype, device=device))
                fvals = scat(fvals, p_f, v_s, torch.where(ramp, cur, value))
                ftarget = scat(ftarget, p_f, v_s, value)
                fstep = scat(fstep, p_f, v_s, new_step)
                fdur = scat(fdur, p_f, v_s, torch.where(ramp, dur, 0))
                felapsed = scat(felapsed, p_f, v_s, -frame)
                ev_frame = scat(zeros(nf, torch.int32), p_f, v_s, frame)
                touched = scat(zeros(nf, torch.bool), p_f, v_s, sel_f)
                row = self._trajectory(fvals, ftarget, fstep, felapsed, fdur, t_idx, dtype)
                pf = torch.where(touched.unsqueeze(-1) & (t_idx >= ev_frame.unsqueeze(-1)),
                                 row, pf)
            if ni:
                sel_i = this & (kind == 2)
                v_i = sel_voice(sel_i)
                ivals = scat(ivals, p_i, v_i, value.to(torch.int32))
                touched_i = scat(zeros(ni, torch.bool), p_i, v_i, sel_i)
                if_frame = scat(zeros(ni, torch.int32), p_i, v_i, frame)
                pi = torch.where(touched_i.unsqueeze(-1) & (t_idx >= if_frame.unsqueeze(-1)),
                                 ivals.unsqueeze(-1), pi)

        # retrigger set masks, block-rate flags and triggers are round-free
        # (a mask fires at every event's frame; the flags were host-deduped)
        f_long = frame.long()
        iset = None
        if ni and any(self._retrigger_ints()):
            sel_i = valid & (kind == 2)
            iset = torch.zeros((ni, V + 1, B), dtype=torch.bool, device=device)
            iset.index_put_((p_i, sel_voice(sel_i), f_long), sel_i)
            iset = iset[:, :V]

        def set_flag(flag, k, vals):
            out = torch.cat([flag, flag.new_zeros((1,))])
            out.index_put_((sel_voice(valid & (kind == k)),), vals)
            return out[:V]

        active = set_flag(state["active"], 3, value > 0.5)
        # note-on (kind 5): clear the voice's idle latch
        idle = set_flag(state["idle"], 5, torch.zeros_like(valid))
        trig = torch.zeros((max(n_trig, 1), V + 1, B), dtype=torch.bool, device=device)
        sel_t = valid & (kind == 1)
        trig.index_put_((param.clamp(0, trig.shape[0] - 1), sel_voice(sel_t), f_long),
                        torch.ones_like(sel_t))
        fstate = (fvals, ftarget, fstep, felapsed, fdur, fsdur)
        return pf, fstate, ivals, pi, iset, trig[:, :V], active, idle

    def process(self, ctx: AudioCtx, state, inputs=None, params=None, events=None):
        """Render one block: (new state, out [outputs, B], done [B]).

        ``events`` is None for an event-free block (the carried ramps
        materialized as they are), else the numpy dict of
        ``node_events_from_lists``, uploaded here. The voice's ``process`` runs once
        over the voice axis with ``[V, B]`` params; inactive voices render
        but are muted; the idle latch takes every voice's done rows. At
        ``WIDE_BATCH_VOICES`` voices and more the voice sees
        ``ctx.wide_batch``. ``inputs`` and ``params`` are unused (a bank is
        controlled by its events); they keep the UGen call shape."""
        V = self.n_voices
        B = ctx.block_size
        dtype = ctx.dtype
        if V >= self.WIDE_BATCH_VOICES and not ctx.wide_batch:
            ctx = dataclasses.replace(ctx, wide_batch=True)
        device = state["fvals"].device
        retrig = self._retrigger_ints()
        if events is not None:
            self._check_burst_rounds()
            n_rounds = self._n_rounds(events)
            (pf, fstate, ivals, pi, iset, trig, active, idle) = self._apply_events_rounds(
                ctx, state, self._events_to(events, device), n_rounds)
        else:
            fstate, ivals, active, idle = self._apply_events(state)
            t_idx = torch.arange(B, dtype=torch.int32, device=device)
            pf = self._trajectory(*fstate[:5], t_idx, dtype) if self._float_names else None
            pi = ivals.unsqueeze(-1).expand(len(self._int_names), V, B)
            iset = None
            trig = torch.zeros((1, V, B), dtype=torch.bool, device=device).expand(
                max(len(self._trig_names), 1), V, B)
        voice_params = {}
        for i, name in enumerate(self._float_names):
            voice_params[name] = pf[i]
        for i, name in enumerate(self._int_names):
            voice_params[name] = pi[i]
            if retrig[i]:
                voice_params[name + "_set"] = (
                    iset[i] if iset is not None
                    else torch.zeros((V, B), dtype=torch.bool, device=device))
        for i, name in enumerate(self._trig_names):
            voice_params[name] = trig[i]

        zero_in = torch.zeros((V, 0, B), dtype=dtype, device=device)
        new_vstate, outs, dones = normalize_process_result(
            self.voice.process(ctx, state["voices"], zero_in, voice_params), ctx)
        # latch per-voice done edges for VoicePool auto-release
        idle = idle | dones.any(dim=-1)
        outs = torch.where(active[:, None, None], outs, torch.zeros((), dtype=outs.dtype,
                                                                     device=device))
        out = outs.sum(dim=0) if self.mix == "sum" else outs.reshape(V * self.voice.outputs, B)
        done = torch.zeros((B,), dtype=torch.bool, device=device)  # banks never free themselves
        fvals, ftarget, fstep, felapsed, fdur, fsdur = self._advance_ramps(fstate, B)
        new_state = {
            "voices": new_vstate,
            "fvals": fvals, "ftarget": ftarget, "fstep": fstep,
            "felapsed": felapsed, "fdur": fdur, "fsdur": fsdur,
            "ivals": ivals, "active": active, "idle": idle,
        }
        return new_state, out, done

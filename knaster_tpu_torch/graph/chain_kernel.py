"""Port of knaster_tpu/graph/chain_kernel.py: a collapsed chain's stage loop in ONE kernel.

The chain-collapse pass (compile._find_chains) runs K isomorphic units as a
loop over the stage axis. On a card that loop runs as one launch of the CUDA
kernel in ``csrc/chain_kernel.cu``: the carried block rows stay on chip
across the stages (one CTA's shared memory for short blocks, a
thread-block cluster's for superblocks, a global workspace only past
that: ``kernels/chain_kernel.py launch_plan``), per-stage params are rows
of the stacked [K, B] planes, staged into shared memory a stage ahead, and
per-stage state (phases, filter and envelope state) is read and written by
stage index, one 32-bit word per value. The kernel is generic:
``lower`` turns a ``ChainPlan`` into a small int32 program once per
structural signature and device (the plan cache shares a plan's
``lowered`` dict among every compile of that signature: graph/compile.py;
no code is generated per graph, so an edit never waits for a compiler),
and ``run`` launches it per block. Done-capable units (the envelopes) write
a done row per stage, which ``run`` hands back as the JAX package's does.

UGens opt in with ``UGen.kernel_stage``. Only the event-free fast program
uses this path, at the native block and at every superblock length the
graph's partition takes (rows beyond a cluster's shared memory go to a
global workspace: ``kernels/chain_kernel.py``); eventful blocks keep the scan
executor, as in the JAX package. ``run`` returns None, and the scan
executor runs, exactly where the JAX package's does: f64 graphs, a unit
with no body (``SinWt(lookup=True)``, Math ``pow``, Math1
``trunc``/``fract``), and state leaves that are not [K] or [K, n] tensors
of 32-bit words. The Mosaic validation valve, the
VMEM budget and the unroll knob exist only for Mosaic and are not ported.

Selection: ``_MODE`` None (the default) runs the kernel on a card and the
scan executor on the CPU, as the JAX package's "auto" does; "1" takes this
path on every device (on the CPU through the kernel's plain version — what
the parity tests use); "0" never.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import chain_kernel as kck
from ..kernels.chain_kernel import (SRC_CARRY, SRC_PLANE, SRC_ROW, SRC_SLOT,
                                    ChainProgram)
from ..ugens.wavetable import FRACTIONAL_PART, TABLE_SIZE

_MODE: Optional[str] = None


def enabled(device) -> bool:
    if _MODE == "0":
        return False
    if _MODE is None:
        return torch.device(device).type == "cuda"
    return True


def ext_descs(cp) -> List[Tuple]:
    """The distinct external ('abs') source descriptors a plan reads, in
    first-use order — the caller resolves each and passes the rows to run()."""
    seen: Dict[Tuple, None] = {}
    for j in range(cp.period):
        for ch_descs in cp.in_pattern[j]:
            for d in ch_descs:
                if d[0] == "abs":
                    seen.setdefault(d)
        for _pidx, d in cp.pe_pattern[j]:
            if d[0] == "abs":
                seen.setdefault(d)
    return list(seen)


def needed_outputs(cg, cp) -> set:
    """The (stage-offset j, channel c) pairs of a chain plan that anything
    OUTSIDE the chain reads — graph outputs, feedback taps, param edges, or
    other nodes' inputs. The kernel writes planes for these only."""
    members = {
        n: j for stage in cp.stages for j, n in enumerate(stage)
    }
    needed = set()
    for nid, per_ch in cg.resolved_in.items():
        if nid in members:
            continue  # intra-chain reads are rel/carry, never planes
        for ch_srcs in per_ch:
            for (kind, s, c) in ch_srcs:
                if kind == "node" and s in members:
                    needed.add((members[s], c))
    for (dst, _pidx), (src, ch) in cg.resolved_param_edges.items():
        if dst not in members and src in members:
            needed.add((members[src], ch))
    for (s, c) in cg.fb_sources:
        if s in members:
            needed.add((members[s], c))
    for srcs in cg.resolved_out:
        for (kind, s, c) in srcs:
            if kind == "node" and s in members:
                needed.add((members[s], c))
    return needed


def lower(cp, reps, ctx, plane_index, exts, needed, state_leaves):
    """The chain kernel's program for a plan (layout in csrc/chain_kernel.cu),
    or None when a unit has no kernel body or its state does not match it.

    ``plane_index`` maps (offset j, param name) to a plane of the stacked
    param planes; ``exts`` orders the external rows; ``state_leaves[j]`` is
    [(name, words)] of offset j's state leaves in sorted order. Returns
    (program, out_map, state_rows, done_map): ``out_map[j]`` the out plane
    of each output channel (or None), ``state_rows[j]`` the first state row
    of offset j, ``done_map[j]`` its done plane (None unless its unit may
    set done)."""
    p = cp.period
    stages = []
    for rep in reps:
        ks = rep.kernel_stage(ctx)
        if ks is None:
            return None
        stages.append(ks)
    # slots: one per output channel of every offset, in offset order
    slot_of, n_slots = {}, 0
    for j, rep in enumerate(reps):
        for c in range(rep.outputs):
            slot_of[(j, c)] = n_slots
            n_slots += 1
    carry_index = {key: i for i, key in enumerate(cp.carry_keys)}
    ext_index = {d: i for i, d in enumerate(exts)}

    def source(d):
        if d[0] == "rel":
            _t, r, c = d
            if r >= 0:
                return (SRC_SLOT, slot_of[(r, c)])
            return (SRC_CARRY, carry_index[(p + r, c)])
        return (SRC_ROW, ext_index[d])

    out_map, state_rows, done_map, n_state, n_out, n_planes = [], [], [], 0, 0, 0
    records = []
    for j, (rep, (body, arg)) in enumerate(zip(reps, stages)):
        if sum(n for _name, n in state_leaves[j]) != body.words(arg):
            return None
        state_rows.append(n_state)
        n_state += body.words(arg)
        ins = [[source(d) for d in ch_descs] for ch_descs in cp.in_pattern[j]]
        edges = {rep.params[pidx].name: d for pidx, d in cp.pe_pattern[j]}
        pars = []
        for name in body.params:
            if name in edges:
                pars.append(source(edges[name]))
            else:
                pars.append((SRC_PLANE, plane_index[(j, name)]))
                n_planes = max(n_planes, plane_index[(j, name)] + 1)
        planes_j = []
        for c in range(rep.outputs):
            if (j, c) in needed:
                planes_j.append(n_out)
                n_out += 1
            else:
                planes_j.append(None)
        out_map.append(planes_j)
        done_map.append(sum(d is not None for d in done_map)
                        if getattr(rep, "may_set_done", False) else None)
        records.append((body.op, arg, ins, pars,
                        [(slot_of[(j, c)], -1 if pl is None else pl)
                         for c, pl in enumerate(planes_j)], state_rows[j],
                        -1 if done_map[j] is None else done_map[j]))

    n_done = sum(d is not None for d in done_map)
    n_scratch = max(body.scratch for body, _arg in stages)
    words = [p, len(cp.carry_keys), n_slots, len(exts), n_state, n_out, n_done,
             n_scratch]
    words += [slot_of[key] for key in cp.carry_keys]
    table = len(words)
    words += [0] * p
    for j, (op, arg, ins, pars, outs, srow, done) in enumerate(records):
        words[table + j] = len(words)
        head = len(words)
        words += [op, arg, len(ins), len(pars), len(outs), srow, 0, 0, 0, done]
        in_tab = len(words)
        words += [0] * (2 * len(ins))
        for c, srcs in enumerate(ins):
            words[in_tab + 2 * c] = len(words)
            words[in_tab + 2 * c + 1] = len(srcs)
            for kind, idx in srcs:
                words += [kind, idx]
        par_tab = len(words)
        for kind, idx in pars:
            words += [kind, idx]
        out_tab = len(words)
        for slot, plane in outs:
            words += [slot, plane]
        words[head + 6:head + 9] = [in_tab, par_tab, out_tab]
    return ChainProgram(tuple(words), n_planes), out_map, state_rows, done_map


def run(cp, reps, ctx, state_stack, planes, plane_index, carry0, ext_rows, needed):
    """Execute the chain plan for one block as one kernel launch.

    state_stack: {"j{j}": {leaf: [K] or [K, n]}}; planes: f32 [n, K, B], the
    params of every (offset, param) without an edge (integer params as
    whole-number floats), plane_index mapping (j, name) to its plane;
    carry0: {"{dj}_{c}": [B] row}; ext_rows: {abs-desc: [B] row} in
    ``ext_descs`` order; needed: ``needed_outputs``. Returns
    (new_state_stack, outs, dones) with outs[j] = [K, out_ch, B] (None for
    offsets nothing outside the chain reads) and dones[j] = [K, B] bool for
    offsets whose unit may set done (None for the rest), or None when the
    plan is not kernel-eligible (the caller runs the scan executor)."""
    if ctx.dtype != torch.float32:
        return None
    K, B = len(cp.stages), ctx.block_size
    leaves = []
    for j in range(cp.period):
        st = state_stack[f"j{j}"]
        names = []
        for name in sorted(st):
            leaf = st[name]
            if leaf.dim() == 0 or leaf.shape[0] != K or leaf.dim() > 2 or (
                    leaf.dtype not in (torch.float32, torch.int32)):
                return None  # not a row of 32-bit words per stage
            names.append((name, 1 if leaf.dim() == 1 else leaf.shape[1]))
        leaves.append(names)
    device = next(iter(carry0.values())).device  # a chain always has a carry
    if cp.lowered is None:
        cp.lowered = {}
    lowered = cp.lowered.get(str(device))
    if lowered is None:  # the plan's program, once per device (stage runs share it)
        lowered = lower(cp, reps, ctx, plane_index, list(ext_rows), needed, leaves)
        cp.lowered[str(device)] = lowered or False
    if not lowered:
        return None
    program, out_map, state_rows, done_map = lowered

    # state words [n_state, K]: the leaves' columns in program order, every
    # word as its int32 bit pattern
    words = []
    for j in range(cp.period):
        st = state_stack[f"j{j}"]
        words += [st[name].reshape(K, n).view(torch.int32).t() for name, n in leaves[j]]
    state = (words[0].contiguous() if len(words) == 1
             else torch.cat(words) if words
             else torch.zeros((0, K), dtype=torch.int32, device=device))
    row_list = list(ext_rows.values()) + [carry0[f"{dj}_{c}"] for (dj, c) in cp.carry_keys]
    rows = (row_list[0].reshape(1, B) if len(row_list) == 1
            else torch.stack(row_list) if row_list
            else torch.zeros((0, B), dtype=torch.float32, device=device))
    if planes is None:
        planes = torch.zeros((0, K, B), dtype=torch.float32, device=device)
    f2pi = float(np.float32(TABLE_SIZE * FRACTIONAL_PART / ctx.sample_rate))
    scale = float(np.float32(2.0 * np.pi / TABLE_SIZE))
    out, state_out, done = kck.chain_kernel(
        program, planes=planes, state=state, rows=rows, K=K, block_size=B, f2pi=f2pi,
        scale=scale, sample_rate=float(ctx.sample_rate))

    new_state_stack = {}
    for j in range(cp.period):
        st, row, new = state_stack[f"j{j}"], state_rows[j], {}
        for name, n in leaves[j]:
            new[name] = (state_out[row:row + n].t().contiguous().view(st[name].dtype)
                         .reshape(st[name].shape))
            row += n
        new_state_stack[f"j{j}"] = new
    outs = {}
    for j, planes_j in enumerate(out_map):
        if all(pl is None for pl in planes_j):
            outs[j] = None
        elif all(pl is not None for pl in planes_j):
            outs[j] = out[planes_j[0]:planes_j[0] + len(planes_j)].transpose(0, 1)
        else:
            zero = torch.zeros((K, B), dtype=torch.float32, device=device)
            outs[j] = torch.stack([out[pl] if pl is not None else zero
                                   for pl in planes_j], dim=1)
    dones = {j: None if d is None else done[d] for j, d in enumerate(done_map)}
    return new_state_stack, outs, dones

#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. device — a CUDA card is required; prints its name and power limit;
2. build — compiles every CUDA kernel of ``knaster_tpu_torch/csrc`` (twelve
   libraries), the two user voices' hand bodies of tools/user_voices.py
   and the six bodies ``kernels/lower.py`` lowers from torch bodies
   (``LOWERED``: the torch-only detuned and organ voices, the bell and
   strings of 17, 32 and 64 modes), each against ``csrc/generic_harness.cuh``,
   one nvcc per source, all at once; prints each library's nvcc seconds
   and each instantiation's registers and spills;
3. kernel vs plain — each bank kernel (sine, FM, subtractive, wavetable,
   and the generic harness with its Sine, FM, Subtractive and Additive
   bodies) in both variants against its plain torch version on the card, at
   V in {1000, 131072} and B = 64, over eventful blocks (restarts, releases
   for the ASR voices, float sets, smoothing configs with ramps in flight,
   a depth-3 burst, active/note-on flags, saturating and negative
   frequencies) and event-free blocks; carried state bit-equal, mix within a
   stated tolerance. Then the two stage-loop kernels: ``fm_cascade`` at N in
   {16, 256} and ``chain_kernel`` on the lowered plans of the 256-stage
   graph cascade and of a 14-stage cascade with a mid-chain tap, each at B
   in {16, 64, 1024} (``fm_cascade`` also at 8,192, the longest superblock
   of a B = 64 render, and at its own limit, in the layout its
   ``launch_plan`` picks and forced to one CTA and to every cluster size
   the card takes), with phases near the top of
   the u32 range, one stage frequency that saturates and one that is
   negative: state and outputs bit-equal. Then the chain kernel's PolyBlep,
   SvfFilter, one-pole, EnvAsr, EnvAr and Pan2 bodies on the lowered plans
   of the subtractive slice's chains (``polyblep_cascade``,
   ``graphic_eq_31``, the one-pole, envelope-mix, FREE_PARENT, EnvAr and
   Pan2 chains) at B in {16, 64, 1024} and at the longest superblock each
   path's render takes, from the
   graph's state and from edge states (phases near 2^32, a cutoff just
   under Nyquist, attacks that cross 1 and releases that end mid-block, an
   EnvAr making both transitions in one block): state words, outputs and
   done rows bit-equal. Then the SinNumeric and Phasor bodies on the
   12-stage Phasor LFO cascade and the 256-stage SinNumeric FM cascade at
   B in {16, 64, 1024} and at the longest superblock, from the graph's
   state and from f32 phases just under the wrap: state words and outputs
   bit-equal. Then the WhiteNoise and SampleDelay bodies on the noise
   chain, the echo chain (rings of 32 and of 2048 samples), the WhiteNoise
   twins of the one-pole and Pan2 chains and the 256-stage SampleDelay
   cascade, at B in {16, 64, 1024} and at the longest superblock, from the
   graph's state and from edge states (frames within 2^10 of 2^32 under
   the seed 2^32 - 1; rings written up to L - 1, delays 0, L - 1, beyond L
   and a per-sample ramp). Every chain path is held in the layout
   ``launch_plan`` picks (one CTA, a thread-block cluster, the global
   workspace), at the longest superblock also under every cluster size
   the card can take, and at NPOT_LEN = 6144 samples, whose cluster chunks
   are not a power of two. Then the chain kernel with its rows forced into
   the global workspace, and in its planned and forced layouts, on the FM,
   Phasor and SinNumeric cascades at 128 x 64 and 128 x 1024 samples, and
   on the FM cascade at 61 and 8191 samples (rows no bulk copy takes); a
   cluster of 32 CTAs must be refused by name. All bit-equal. Then the
   generic harness's
   Envelope body (a four-shape table, looping and not) and Modal body (the
   bell, bar and string presets, M = 12, 6 and 16) at V = 1000 (their full
   sizes are the matrix's and the slices'), B = 64 over four blocks and
   B = 1024 over two (the Modal bell one): restarts, t_stops in curved
   segments, time_scale and freq ramps, segments ending mid-block, strikes
   mid-block, decays where the polynomial exp underflows, modes past pi,
   a depth-3 burst. Carries bit-equal but the envelope's frozen value,
   within EFROM_ULPS ulps (the kernel's cosf/expf/logf against torch's).
   Then the matrix of the bank kernels' Hopper design: the hand sine,
   subtractive and FM kernels, the wavetable kernel and every generic body (the
   Envelope body on the four-shape table, looping and one-shot; the Modal
   body on the bar) at (V, B) in MATRIX_CELLS: V in {1000, 131055} at B =
   64 and 131055 at B = 1024 (131055: a last CTA with whole
   warps past the bank and a ragged one; 131,072 voices at B = 64 are the
   kernel-vs-plain phase's and the slices'),
   an eventful block and then an event-free one whose pan, cutoff and q
   ramps (and the hand kernels' freq and amp, the FM kernel's ratio and
   index) meet the flat-ramp rules'
   edge cases (a glide, a ramp ended exactly at sample 0, a zero step
   ending inside the block at another target, a signed zero); for the hand
   kernels those cases fill two warps of three and the third keeps flat
   ramps with some freqs at 0, and the envelopes are set by warp
   (sustained or, EnvAr, attacking; stopped; alternating lanes; the
   eventful block's own), so
   that both sides of every warp-uniform hoist run; the wavetable kernel
   and the Additive body also at H in {1, 17, 64} and past the unrolled
   instantiations at 65 (the run-time variant); at V =
   131055, B = 64 two launches on the same buffers must give
   bit-identical mixes (the in-kernel sum's tickets reset). Carries
   bit-equal, mixes within the tolerance. Then the four hand bank kernels
   and the generic FM body against the composable ``VoiceBank`` of the
   same voice on the card (the JAX package's vmap bank, plain torch), V =
   1024, four eventful blocks, mix within 1e-5 (``phase_kernels_vs_vmap``);
4. slices — each bank through its public API at 131,072 voices, B=64,
   48 kHz, with the JAX package's seeded defaults: the sine bank through
   ``bench.py``'s sequence (512 staged trigger blocks of 256 events), the
   FM, subtractive and wavetable banks and the generic harness with its
   Sine, FM, Subtractive and Additive bodies through 32 staged
   trigger blocks of 4096 events (``benchmarks/suite.py``'s
   event_capacity); then 750 event-free blocks (1 s of audio). Checks that
   every block launched the bank's kernel (its launch counter, reset just
   before), that every voice sounded, that the mix is finite and not
   silent, that the generic FM bank matches the hand FM bank, and prints
   voice-samples/s (and two more renders' rates, for the host's spread).
   Then ``envelope_bank`` (131,072 voices of the suite's looping 4-segment
   program, 4096 restarts in block 0) and ``modal_bank`` (65,536 bell
   voices, 4096 strikes) the same way, with their idle latches checked.
   Then the graph slices through ``AudioProcessor.render`` on the card:
   ``readme_sine`` (0.5 s, against the port's CPU render) and the README
   example with smoothing and a scheduled set (2 s); ``fm_cascade`` (256
   SinWt stages as graph nodes, B=64, 2 s, the chain kernel once per
   superblock, against the scan executor over 64 blocks);
   ``fm_cascade_model`` (``FMCascade(256)``, the fm_cascade kernel once per
   superblock);
   ``sines_const`` (256 independent sines, B=16 and 64, no kernel). Then
   the subtractive slice: ``subtractive_voice`` (the golden config, 0.4 s,
   against the port's CPU render, no kernel); ``polyblep_cascade`` (256
   PolyBlep stages) and ``graphic_eq_31`` (a saw into 31 Bell SVFs), B=64,
   2 s each, the chain kernel once per event-free superblock, against the
   scan executor over 64 blocks; the one-pole, envelope, FREE_PARENT and
   Pan2 chains at B=16 against the scan executor (the FREE_PARENT chain's
   output zero from its done frame on). Each prints realtime x (samples/s
   / 48,000). Then golden ``param_sweep`` at f32 and f64 against the port's
   CPU render. Then every graph slice, the param sweep's two cascades
   included, rendered twice from one schedule (the 2 s slices for one
   128-block superblock, PARTITION_SECONDS), with superblocks and block
   by block (``render_chunk_blocks=1``): bit-equal where the phases are
   u32, within a stated tolerance where a float scan spans the superblock;
   each render's realtime x and kernel launches per rendered second, and
   the superblocked render's own kernel launches (one per superblock).
   Then the FDN slice: ``phasor_cascade`` and ``sin_numeric_cascade`` over
   their first 128 blocks on the card against the CPU (the same (program,
   length) sequence, one superblock, within 1e-6); the noise chain, the
   echo chain and the SampleDelay cascade (B=64, 2 s, the chain kernel once
   per superblock, the first two against the scan executor over 64
   blocks); golden ``fdn_galactic`` (1 s, block by block behind its
   feedback edges) against the CPU render and the f32 fixture, read
   through the port's codec (``utils/codec.py``, which builds
   native/knaster_flac.cpp); ``galactic_chain`` superblocked and per
   block against the CPU. Then ``pool_envelope_bank``: a 131,072-voice
   ``FusedVoiceBank(EnvelopeVoice())`` graph node under a ``VoicePool``
   taking every voice in 1,024 sample-accurate note-ons a block for 128
   blocks, rendered to POOL_SECONDS (1 s) with superblocks and block by block (the generic
   kernel once per eventful block and per superblock), every voice
   released by ``refresh()``, the first POOL_HEAD blocks against the CPU
   render;
   and ``modal_bells`` (examples/modal_bells.py's four bells, 4 s, no
   kernel) against the CPU within 1e-6. Then the vmap ``VoiceBank``, no
   kernel of the port on its path: golden ``detuned_banks`` (two 512-voice
   banks, FM and additive) at f32 and f64, superblocked and per block,
   against the fixture (the golden gate; at f32 up to DETUNED_F32_MISSES
   samples may miss it by one FM table step, named as they miss), the
   port's CPU render and each other, realtime x and launches per
   rendered second; the suite's ``fm_voice_bank`` (8192 FM voices) and
   ``plucked_bank`` (4096 strings), ``bank.process`` over 750 event-free
   blocks after a block of note-ons, against the CPU over 4 blocks,
   voice-samples/s, kernels per block and the device-busy share. Then
   buffers and samples (``phase_buffers``), no kernel of the port on
   their path but the sampler voices' EnvAsr's, each through
   ``AudioProcessor.render`` at the suite's width:
   ``sampler_bank`` (16,384 tiled ``SamplerVoice``s over a 1 s tone) and
   ``sampler_resample`` (the same with rates U(0.5, 1.99)), a block of
   note-ons then event-free blocks; ``granular`` (one ``GrainPlayer`` of 64
   grains) and ``granular_bank`` (64 players, which must batch into one
   plan item); ``convolver`` (``WhiteNoise`` into a 2 s stereo IR, 1500
   partitions, run with TF32 switched on by the caller and held against a
   direct f64 convolution within the reference's 2e-4); ``drum_machine``
   (examples/drum_machine.py's three tiled sampler banks, one bar of
   ``set_after`` hits). Each superblocked over BUFFER_SECONDS (the drums
   over their bar, the sampler banks over SAMPLER_SECONDS and
   SAMPLER_RESAMPLE_SECONDS) against its per-block render of the first
   BUFFER_PER_BLOCK_SECONDS and that against
   the port's CPU render of its first blocks, within stated gates;
   voice-samples/s or realtime x, kernels a block and the busy share.
   Then the live path (``phase_live``): the four scenarios of the JAX
   package's realtime soak at its sizes (``tools/realtime_soak.py``:
   ``bank``, 131,072 sine voices; ``cascade``, 256 modulated ``SinWt``;
   ``ir``, a 2 s convolver; ``edit``, 64 sines restructured live), each
   warmed as a stream warms it and bounced over two scripted 64-block
   chunks (the programs each chunk took printed; the sine kernel's
   eventful 1024-sample superblocks and its other eventful and first
   event-free calls against its plain version on the card; the cascade's
   chain kernel, a float-event block 0 included, bit-equal to the scan
   executor and within LIVE_FM_GATE of the CPU; ``ir`` and ``edit``
   within LIVE_CPU_GATE of the CPU), then streamed through
   ``StreamBackend`` for LIVE_SECONDS with live control: one JSON row
   each (underruns, the ring's frames against the wall, the peak,
   startup, chunk ms, the busy share of a profiled second, edit to
   audible), the ring at least LIVE_WRITTEN of real time, every edit
   heard, no thread failed; and the bank's state saved, loaded into a
   fresh processor and rendered on bit-equal; the pink noise kernel (the
   ``ir`` scenario's source, one launch a block where its plain version
   launched ~700 operations) bit-equal to its plain version at the live
   chunk's block and superblock lengths, f32 and f64, and timed.
   Then the program and plan caches (``phase_program_cache``): re-pushed
   graphs and banks are hits, bit-equal to fresh compiles. Then voices
   sharded over devices in one process (``phase_mesh``,
   ``parallel/mesh.py``; on one card cuda:0 MESH_SHARDS times, with more
   cards also one shard a card): the sine bank at 131,072 voices, every
   voice restarted, over one shard bit-equal to the unsharded bank and over
   MESH_SHARDS within ``mesh_gate`` (1e-6 of the voices' summed
   amplitude), each one's host ms a block; the wavetable bank and the
   Envelope body at 16,384 voices the same way; tools/mesh_voice_cluster.py
   with the fused sine bank against the same graph unsharded, then an
   event-free render whose block lengths the local bank saw are printed
   (none past MAX_BLOCK); a ``VoicePool`` over a mesh of the Envelope body
   releasing every voice; the mesh graph's checkpoint restored shard by
   shard and resumed bit-equal; every kernel of the phase launched.
   Then the user's side (``phase_extensions``): the user voices'
   CUDA bodies (``DetunedVoice``, mono, and ``OrganVoice``, stereo with the
   exact pan, from tools/user_voices.py) in the generic harness against
   their torch bodies at V in {1000, 131072}, B = 64, eventful and
   event-free (carry bit-equal, mix within the gate), the detuned bank's
   slice at 131,072 voices; examples/custom_voice_bank.py (512
   OrganVoices, its defaults and four chords) through
   ``AudioProcessor.render`` for ORGAN_SECONDS, realtime x, and its four
   chords ORGAN_CMP_SPACING apart on the card against the port's CPU
   render; and a graph of ``OscWt``
   over the anti-aliased ``Wavetable`` (a 20 Hz -> 20 kHz glide and a
   reset), ``wr_mul``, ``SafetyLimiter``, ``@ugen`` and ``@ugen.sample``
   UGens, ``ugen_from_sample_fn``, ``WrArParamToInput`` driven by a
   ``Phasor`` and ``DoneOnTrig`` freeing its subgraph, on the card against
   the CPU within EXT_GATE, realtime x and launches per rendered second.
   Then the voices that reach the card from their torch bodies alone
   (``phase_lowered``): each lowered body against its torch body on the
   card (the torch-only ``DetunedVoice`` and ``OrganVoice`` at V in {1000,
   131072} over ``schedule``, the bell and the 17-, 32- and 64-mode strings
   over ``body_schedule``'s four blocks at V = 1000; eventful and
   event-free, carry bit-equal, mix within the gate);
   the lowered bell's carry bit-equal to
   the library ``modal12`` body's; each lowered bank's slice (a trigger
   block and LOWERED_SLICE_BLOCKS event-free blocks through
   ``bank.process``, its launches; the kernels a block of the 64-mode bank,
   whose ``idle_of`` is eager); examples/custom_voice_bank.py's score
   through the torch-only organ against the CPU render within 1e-6 x
   max(1, peak), realtime x; and each lowered body's kernel ms, event-free
   and eventful, beside the hand or library body it stands in for on the
   same operands, with its plain ms and its bound from the operations the
   voice's function needs on the timed state (the hand count of the body it
   stands in for, ``modal_ops`` for the Modal bodies), the lowering's own
   count beside it. Then the ten examples that had not run on the port
   (``phase_examples``, tools/port_examples.py): ``simple_sine``,
   ``visualize_graph`` (its dot source and ``show_dot_svg``),
   ``many_sines`` (600 vmap ``SineVoice``s), ``voice_pool`` (a 64-voice
   vmap bank into Galactic under ``VoicePool``), ``wavetable_orchestra``
   (16,384 voices of the wavetable kernel, its 24 trigger and 8 release
   waves, 10 s), ``plucked_strings`` and its shimmer,
   ``granular_texture`` and its ensemble, ``ir_reverb`` (a 2 s IR),
   ``buffer_player`` (``BufferReader``, one launch of the buffer reader
   kernel a block) each through ``AudioProcessor.render`` at its
   EXAMPLE_RUNS cut, its first frames against the port's CPU render within
   1e-6 x max(1, peak), realtime x, the wavetable and buffer reader
   kernels launched by their examples and no other kernel there; and
   ``live_edit`` streamed through ``StreamBackend`` with its live
   Galactic insert: the swap to the edit's revision, finite audio, the
   ring at LIVE_WRITTEN of real time, underruns and chunk ms printed.
   ``buffer_player`` and ``live_edit`` also print the reader's and
   EnvAsr's launches by block length (``launch_tally``). Then the buffer
   reader kernel bit-equal to its plain version at READER_CASES (B in {64,
   1024, 4096}, one and several instances, mono and stereo, f32 and f64,
   restarts, loops and ends, shared-memory tiles crossed, instances past a
   CTA's, 16,384 readers), the SVF kernel at SVF_CASES (every filter type,
   audio-rate cutoff and q, +-12 dB), the Galactic kernel at
   GALACTIC_CASES (B from 1 to its 740-sample cap, moved states, silence)
   and the EnvAsr kernel at ENV_CASES (the state machine and both closed
   forms, every stage, tiles crossed, instances past a CTA's, the rows in
   shared memory and past it in the global workspace, 16,384 envelopes on
   every path) and ENV_GLOBAL_CASES (forced into the global workspace), f32
   and f64, each timed (the reader and EnvAsr also at 16,384 instances, B
   = 64, and at 8192 samples). Those three
   keep the live example streaming on slow hosts: SvfFilter, Galactic and
   EnvAsr each run their block in one launch wherever their process runs
   on the card, so the slices with them expect their launches (the
   subtractive voice, the FDN, galactic_chain, the detuned and sampler vmap
   banks, the partitions of the env and SVF chains' eventful blocks);
5. timings — per bank kernel and generic body at V=131072
   (the Modal body at 65,536), B=64: kernel ms (device time: the
   ``launch()`` calls into preallocated outputs captured in a CUDA graph and
   replayed between CUDA events, and beside it the eager time over
   back-to-back calls, which a short kernel's host launch rate can set),
   wrapper ms (the wrapper also captured in a CUDA graph) and plain ms,
   event-free and eventful (the
   Envelope and Modal bodies also at B = 1024 event-free), the hand sine,
   subtractive and FM kernels' bound counted on the path each warp of the
   timed state takes (``hand_ops_per_sample``: the hoisted path's
   FLAT_OPS_PER_SAMPLE, a quiet warp's QUIET_OPS_PER_SAMPLE, the general
   OPS_PER_SAMPLE printed beside it); the FM kernel, whose slice ends with
   every voice stopped, also at a sounding state (``sounding_state``);
   and the stage-loop kernels at B in
   {16, 64, 1024} and at the longest superblock their renders take
   (fm_cascade at N = 256, the chain kernel on the FM cascade,
   ``polyblep_cascade``, ``graphic_eq_31``, ``phasor_cascade`` and
   ``sin_numeric_cascade``, the noise chain, the echo chain and the
   SampleDelay cascade): kernel ms and the layout each launch took, beside
   the parent design's ms from one call on the card (PARENT_CHAIN_MS; the
   FM cascade's at the superblock length also with its rows in the global
   workspace), and at the superblock length the
   profiler's device time and plain ms; and the live path's two rows,
   the sine kernel on an eventful 1024-sample superblock of ``bank`` and
   the chain kernel on ``cascade``'s float-event block, each with its
   launches in the soak; and the buffer reader kernel at
   ``buffer_player``'s shape (one mono reader, B = 64), with its launches
   in that example, the SVF and Galactic kernels at live_edit's 704-sample
   superblocks and the EnvAsr kernel's state machine at B = 64, with their
   launches in ``live_edit``. Every kernel row carries its bound (the larger of its bytes
   over HBM bandwidth and its f32 operations over the unfused f32 peak),
   at the superblock length.

The last lines are the kernel table (JSON), the card's ``name,
power.limit`` and ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SR = 48000
N_VOICES = 131072  # bench.py's and benchmarks/suite.py's banks
BLOCK = 64
N_BLOCKS = SR // BLOCK  # 750 event-free blocks: 1 s of audio
SUITE_CAPACITY = 4096  # benchmarks/suite.py's event_capacity for the banks
H = 16  # bench_wavetable_bank's partials

# the TPU kernel each port kernel replaces
REPLACES = {
    "sine_bank": "knaster_tpu/parallel/pallas_bank.py:714",
    "fm_bank": "knaster_tpu/parallel/pallas_bank.py:915",
    "sub_bank": "knaster_tpu/parallel/pallas_bank.py:1093",
    "wt_bank": "knaster_tpu/parallel/pallas_bank.py:1325",
    "generic_bank": "knaster_tpu/parallel/generic_bank.py:103",
    "fm_cascade": "knaster_tpu/models/voices.py:639",
    "chain_kernel": "knaster_tpu/graph/chain_kernel.py:155",
    # no Pallas kernel: the JAX package renders PinkNoise in XLA
    "pink_noise": "knaster_tpu/ugens/noise.py:171 (PinkNoise.process in XLA, no Pallas kernel)",
    # no Pallas kernel: the JAX package renders BufferReader as a lax.scan
    "buffer_reader": ("knaster_tpu/ugens/buffer.py:109 (BufferReader.process, a lax.scan in "
                      "XLA, no Pallas kernel)"),
    # no Pallas kernel: the JAX package renders SvfFilter as an affine scan in XLA
    "svf_filter": ("knaster_tpu/ugens/filters.py:158 (SvfFilter.process, an affine scan in "
                   "XLA, no Pallas kernel)"),
    # no Pallas kernel: the JAX package renders Galactic in XLA
    "galactic": ("knaster_tpu/airwindows/galactic.py:113 (Galactic.process in XLA, no Pallas "
                 "kernel)"),
    # no Pallas kernel: the JAX package renders EnvAsr in XLA
    "env_asr": ("knaster_tpu/ugens/envelopes.py:157 (EnvAsr.process, a lax.scan or a closed "
                "form in XLA, no Pallas kernel)"),
}
CASCADE = 256  # benchmarks/suite.py's bench_fm_cascade and bench_fm_cascade_model
GRAPH_SECONDS = 2.0
STAGE_BLOCKS = (16, 64, 1024)  # the block sizes the chain kernel is held and timed at
CHUNK = 128  # AudioProcessorOptions.render_chunk_blocks: the longest superblock, in blocks
WARM_BLOCKS = 4  # blocks rendered before a timed graph render: they carry the param sets

# The card's peaks for the bound: HBM bytes/s (NVIDIA's H100 SXM data
# sheet) and the f32 operations/s these kernels can reach. The data sheet's
# 67 TFLOP/s outside the tensor cores counts a fused multiply-add as two
# operations; every kernel here is built with --fmad=false (each product
# and sum rounds on its own, as the plain versions do), so its operations
# issue one at a time: 132 SMs x 128 f32 lanes x 1.98 GHz = 33.5e12 a
# second at most. A bound is the larger of bytes over the one and
# operations over the other, each input byte read once and each output
# written once.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 33.5e12
# f32 operations a kernel does per voice-sample (banks) or per stage-sample
# (fm_cascade), counted from each kernel's per-sample arithmetic with every
# add, multiply, divide, compare-select and transcendental call as one
# operation: a lower bound on the work
OPS_PER_SAMPLE = {"sine_bank": 40, "fm_bank": 60, "sub_bank": 70, "wt_bank": 110,
                  "generic_bank": 60, "fm_cascade": 8,
                  # the generic harness's bodies repeat their hand banks' math
                  "generic-sine": 40, "generic-fm": 60, "generic-subtractive": 70,
                  "generic-additive": 110,
                  # the user bodies (tools/user_voices.py), counted from their
                  # sources and the harness (csrc/generic_harness.cuh) on an
                  # event-free sample: USER_OPS_PER_SAMPLE
                  "generic-user-detuned": 82, "generic-user-organ": 128,
                  # three Threefry-2x32 evaluations a sample (2 + 5 x 23 u32
                  # operations each), two uniforms (6 each), the octave
                  # recurrence (9), the base-16 scan (2) and the output (2)
                  "pink_noise": 3 * 117 + 2 * 6 + 9 + 2 + 2}
# the user bodies' count on an event-free sample, item by item from
# DETUNED_SOURCE, ORGAN_SOURCE, bank_common.cuh and the harness's sample():
# the harness's sample index (1) and each float param it reads (mat_base's
# add, compare-select, multiply and add: 4), the active gain (1 a channel)
# and the mix (2 a channel: the tile store and its add); env_ar with no
# restart (14: t*t*t and two compare-selects for the level, an add, a
# subtract and two compare-selects for t, a compare and two selects each
# for the release and the stop); sin_quant (19: five integer operations of
# the quadrant fold, the sign's compare and select, the conversion, the
# scale and sin_poly's ten); to_inc (3: max, min, conversion) with its
# multiplies and the u32 add. Detuned: 1 + 3 params (12) + env_ar (14) +
# two sines (38) + the increments (5 and 6) + the gain (3) + active (1) +
# mix (2) = 82. Organ with its pan flat over the block (the harness takes
# the exact gains once a block there): 1 + 4 params (16) + env_ar (14) +
# three sines (57) + the drawbars and gain (6) + the increments (5, 6, 6)
# + the pan gains' two multiplies + active (2) + mix (4) = 119; where the
# pan moves, its read (4), the angle (3), cosf and sinf (2) each sample:
# 128 (user_ops_per_sample counts the warps that take the hoist)
USER_FLAT_PAN_OPS_PER_SAMPLE = {"generic-user-organ": 119}
# the same count on the path the hand kernels take for a warp whose ramps are
# all flat over the block (hand_ops_per_sample counts the warps that take
# it), for the sine and subtractive kernels also with every voice sustained
# or stopped: what is taken once a block (the envelope, amp, pan gains and
# increment; the SVF coefficients and dt; freq, ratio, index, amp and the
# modulator's increment) leaves the sine's 9 (the quadrant fold's six
# integer operations, the shared-memory table read and the sign), the phase
# add, three multiplies and the mix's 2 a channel (the tile store and its
# add); the saw, the BLEP's compares (its divide is rarely needed), the SVF
# step, one multiply and the mix; the FM voice's EnvAr (8), two sines, the
# modulator's phase add, the carrier's frequency (3) and increment (4) and
# phase add, the gain, one multiply and the mix
FLAT_OPS_PER_SAMPLE = {"sine_bank": 17, "sub_bank": 28, "fm_bank": 39}
# the count on a warp whose every gain is zero (stopped voices, flat amps):
# the sine kernel adds its B increments at once and sums nothing; the FM
# kernel still runs both phase recurrences sample by sample (the carrier's
# increment reads the modulator's sine): the modulator's sine and phase add,
# the carrier's frequency and increment and its phase add, and no mix
QUIET_OPS_PER_SAMPLE = {"sine_bank": 0, "fm_bank": 18}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_name_and_limit():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0].strip()


def mix_tolerance(V, peak):
    # the kernels sum each sample's mix in their own fixed order (CTA tiles
    # or warp rows and then CTA and group rows), the plain version as one
    # torch.sum over V: the same terms in another order, so the f32
    # rounding differs and grows
    # with the number of terms (~sqrt(V)) and the magnitude of the sum.
    # Kernels that take sinf/cosf/sincosf (wavetable, generic Sine/Additive)
    # may differ from torch's by an ulp per term, far below this bound at
    # these amplitudes
    return 1e-5 * math.sqrt(V / 1024.0) * max(1.0, peak)


def bits(x):
    import torch

    return x.view(torch.int32) if x.dtype == torch.float32 else x


# --------------------------------------------------------------------------
# the banks: seeded defaults as the JAX package's benchmarks set them
# --------------------------------------------------------------------------

def sine_defaults(np, V, seed=0, amp=0.01):
    """bench.py's bank (bench.py:40-45)."""
    rng = np.random.default_rng(seed)
    return {"freq": rng.uniform(100.0, 4000.0, V).astype(np.float32),
            "amp": np.full(V, amp, np.float32),
            "pan": rng.uniform(-1.0, 1.0, V).astype(np.float32)}


def fm_defaults(np, V, seed=0, amp=0.005):
    """benchmarks/suite.py:550-555 (bench_fm_bank, bench_generic_bank)."""
    rng = np.random.default_rng(seed)
    return {"freq": (220.0 * 2 ** rng.uniform(-1, 1, V)).astype(np.float32),
            "ratio": rng.choice([0.5, 1.0, 2.0, 3.0], V).astype(np.float32),
            "index": rng.uniform(0.5, 3.0, V).astype(np.float32),
            "amp": np.full(V, amp, np.float32)}


def sub_defaults(np, V, seed=0, amp=1e-4):
    """benchmarks/suite.py:837-842 (bench_subtractive_bank)."""
    rng = np.random.default_rng(seed)
    return {"freq": rng.uniform(55, 880, V).astype(np.float32),
            "cutoff": rng.uniform(400, 8000, V).astype(np.float32),
            "q": rng.uniform(0.7, 4.0, V).astype(np.float32),
            "amp": np.full(V, amp, np.float32)}


def wt_defaults(np, V, seed=0, amp=1e-4):
    """benchmarks/suite.py:771-778 (bench_wavetable_bank)."""
    rng = np.random.default_rng(seed)
    return {"freq": rng.uniform(50, 2000, V).astype(np.float32),
            "amp": np.full(V, amp, np.float32),
            "pan": rng.uniform(-1, 1, V).astype(np.float32)}


def detuned_defaults(np, V, seed=0, amp=0.005):
    """tests/test_generic_bank.py's user voice: two sines detuned by up to 1%."""
    rng = np.random.default_rng(seed)
    return {"freq": rng.uniform(100, 900, V).astype(np.float32),
            "detune": rng.uniform(1.0, 1.01, V).astype(np.float32),
            "amp": np.full(V, amp, np.float32)}


def saw_table(ktt, n_harmonics=H):
    """bench_wavetable_bank's table: a saw of H harmonics."""
    nb = ktt.NonAaWavetable()
    nb.add_saw(1, n_harmonics + 1, 1.0)
    return nb.buffer


def make_bank(ktt, np, kind, V, capacity, seed=0, amp=None, n_harmonics=H):
    """A bank of one kind with its benchmark's seeded defaults. Kinds:
    sine, fm, sub, wt (the hand banks) and generic-<body>, the bodies of
    the library voices, generic-user-detuned and generic-user-organ
    (tools/user_voices.py, their hand CUDA bodies) and the voices whose
    torch bodies the card runs lowered (``LOWERED``): the torch-only
    detuned and organ voices, the bell (M = 12) with its library body
    dropped and strings of 17, 32 and 64 modes on ``modal_bank``'s defaults;
    the wavetable and Additive banks of ``n_harmonics`` partials."""
    amp_kw = {} if amp is None else {"amp": amp}
    if kind == "sine":
        return ktt.FusedSineVoiceBank(
            V, voice_defaults=sine_defaults(np, V, seed, **amp_kw),
            event_capacity=capacity)
    if kind == "fm":
        return ktt.FusedFMVoiceBank(
            V, voice_defaults=fm_defaults(np, V, seed, **amp_kw),
            event_capacity=capacity)
    if kind == "sub":
        return ktt.FusedSubtractiveVoiceBank(
            V, voice_defaults=sub_defaults(np, V, seed, **amp_kw),
            event_capacity=capacity)
    if kind == "wt":
        return ktt.FusedWavetableVoiceBank(
            V, table=saw_table(ktt, n_harmonics), n_harmonics=n_harmonics,
            voice_defaults=wt_defaults(np, V, seed, **amp_kw),
            event_capacity=capacity)
    body = kind.split("-", 1)[1]
    uv = user_voices_module()

    def organ(np, V, seed=0, amp=0.003):
        return {**uv.organ_defaults(V, seed), "amp": np.full(V, amp, np.float32)}

    def modal(np, V, seed=0, amp=0.01):
        return {**modal_defaults(np, V, seed), "amp": np.full(V, amp, np.float32)}

    def string(n_modes):
        return ktt.ModalVoice(ktt.ModalResonator.string(330.0, n_modes=n_modes))

    voice, defaults = {
        "user-detuned": (uv.DetunedVoice(), detuned_defaults),
        "user-organ": (uv.OrganVoice(), organ),
        "lowered-detuned": (uv.torch_only(uv.DetunedVoice()), detuned_defaults),
        "lowered-organ": (uv.torch_only(uv.OrganVoice()), organ),
        "lowered-modal12": (uv.torch_only(ktt.ModalVoice(ktt.ModalResonator.bell(330.0))),
                            modal),
        "lowered-modal17": (string(17), modal),
        "lowered-modal32": (string(32), modal),
        "lowered-modal64": (string(64), modal),
        "sine": (ktt.SineVoice(), sine_defaults),
        "fm": (ktt.FMVoice(), fm_defaults),
        "subtractive": (ktt.SubtractiveVoice(), sub_defaults),
        "additive": (ktt.AdditiveVoice(table=saw_table(ktt, n_harmonics),
                                       n_harmonics=n_harmonics),
                     wt_defaults),
    }[body]
    return ktt.FusedVoiceBank(voice, V, voice_defaults=defaults(np, V, seed, **amp_kw),
                              event_capacity=capacity)


# the other float param each schedule ramps, and its target
OTHER = {"pan": 0.9, "ratio": 3.0, "cutoff": 900.0, "detune": 1.02}


def schedule(bank, V, B):
    """Per-block event lists adapted to the voice's params: an eventful
    block exercising every event kind, event-free blocks with ramps in
    flight, a second eventful block (releases for the ASR voices, more
    restarts for the AR one)."""
    tr = bank.trig_index("t_restart")
    tq = bank.trig_index("t_release") if "t_release" in bank._trig_names else None
    fi, ai = bank.float_index("freq"), bank.float_index("amp")
    other = next(n for n in bank._float_names if n in OTHER)
    oi = bank.float_index(other)
    ev0 = [(v % B, v, tr, 1, 0.0) for v in range(0, V, 3)]
    if tq is not None:
        ev0 += [(B // 2, v, tq, 1, 0.0) for v in range(0, V, 9)]  # attack -> release
    ev0 += [
        (0, 7, fi, 0, 1234.0),                 # jump
        (B // 3, 8, ai, 0, 0.05),              # mid-block amp set
        (0, 9, oi, 4, float(2 * B)),           # smoothing config ...
        (1, 9, oi, 0, OTHER[other]),           # ... then a ramp over 2 blocks
        (0, 11, fi, 4, float(3 * B)),
        (2, 11, fi, 0, 2500.0),                # freq ramp in flight for 3 blocks
        (B // 4, 12, fi, 0, 700.0),            # depth-3 burst on one slot:
        (B // 2, 12, fi, 4, 0.0),              #   set, freeze, set
        (3 * B // 4, 12, fi, 0, 300.0),
        (0, 13, ai, 3, 0.0),                   # set inactive
        (0, 14, ai, 5, 0.0),                   # note-on
        (5 % B, 15, fi, 0, 1.0e5),             # saturating increment
        (6 % B, 16, fi, 0, -300.0),            # negative frequency: no advance
        (0, 17, fi, 4, float(B)),
        (B - 1, 17, fi, 0, 1.0e5),             # ramp into saturation
    ]
    second = tq if tq is not None else tr
    ev3 = [(v % B, v, second, 1, 0.0) for v in range(1, V, 3)]  # sustain -> release
    ev3 += [(0, 13, ai, 3, 1.0), (B // 2, 20, tr, 1, 0.0)]
    return [ev0, None, None, ev3, None]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def kernel_module(kind):
    from knaster_tpu_torch.kernels import (fm_bank, generic_bank, sine_bank,
                                           sub_bank, wt_bank)

    if kind.startswith("generic"):
        return generic_bank
    return {"sine": sine_bank, "fm": fm_bank, "sub": sub_bank, "wt": wt_bank}[kind]


def plain_of(mod):
    return getattr(mod, mod.KERNEL + "_plain")


def compare_block(torch, kind, bank, operands, label, loose=(), plain_on_cpu=False):
    """Run the kernel and the plain version on the same operands; require
    bit-equal state and the mix within tolerance. ``loose`` names rows of
    the generic kernel's packed carry that may differ: their largest
    difference in ulps is returned. ``plain_on_cpu`` runs the plain version
    on a CPU copy of the operands, for a small bank whose plain version's
    per-sample ops cost less there than as launches on the card: the same
    f32 arithmetic (where torch's CPU and CUDA libm differ, the value
    reaches only the mix or a ``loose`` row). Returns (kernel outputs, max
    |mix difference|, ulps)."""
    mod = kernel_module(kind)
    k = bank.kernel(**operands)
    if plain_on_cpu:
        cpu_ops = {n: x.cpu() if isinstance(x, torch.Tensor) else x
                   for n, x in operands.items()}
        p = tuple(x.to(k[0].device) for x in plain_of(mod)(**cpu_ops))
    else:
        p = plain_of(mod)(**operands)
    torch.cuda.synchronize()
    ulps = 0
    for n, (a, b) in enumerate(zip(k[1:], p[1:])):
        if torch.equal(bits(a), bits(b)):
            continue
        if loose and all(r in loose for r in range(a.shape[0])
                         if not torch.equal(a[r], b[r])):
            ulps = max(ulps, int((a.long() - b.long()).abs().max()))
            continue
        diff = int((bits(a) != bits(b)).sum())
        fail(f"{label}: state output {n} differs from the plain version "
             f"in {diff} words")
    if not bool(torch.isfinite(k[0]).all()):
        fail(f"{label}: non-finite mix")
    err = float((k[0] - p[0]).abs().max())
    peak = float(p[0].abs().max())
    V = bank.n_voices
    if err > mix_tolerance(V, peak):
        fail(f"{label}: mix differs by {err} (peak {peak}, tolerance "
             f"{mix_tolerance(V, peak)})")
    return k, err, ulps


def phase_kernel_vs_plain(torch, np, ktt, dev, kind, Vs=(1000, N_VOICES),
                          Bs=(48, 64, 1024)):
    """One kernel (or generic body) against its plain version over the
    schedule at every V and B; returns the max |mix difference|."""
    max_err = 0.0
    for V in Vs:
        for B in Bs:
            ctx = ktt.AudioCtx(SR, B, torch.float32)
            bank = make_bank(ktt, np, kind, V, capacity=V, seed=V + B, amp=0.01)
            state = bank.init(ctx, device=dev)
            # phases near the top of the u32 range: the add must wrap
            rng = np.random.default_rng(V + B)
            for name in ("phase", "phm", "phc", "p1", "p2", "p3"):
                if name in state:
                    state[name] = torch.from_numpy(
                        rng.integers(2**32 - 2**26, 2**32, V, dtype=np.uint64)
                        .astype(np.uint32).view(np.int32)).to(dev)
            peak = 0.0
            for blk, evs in enumerate(schedule(bank, V, B)):
                events = None if evs is None else bank.node_events_from_lists(evs)
                operands, carry = bank.kernel_operands(ctx, state, events)
                k, err, _ = compare_block(torch, kind, bank, operands,
                                       f"{kind} V={V} B={B} block {blk}")
                max_err = max(max_err, err)
                peak = max(peak, float(k[0].abs().max()))
                state, _ = bank.finish(ctx, carry, k)
            if peak == 0.0:
                fail(f"{kind} V={V} B={B}: silent mix")
        print(f"kernel vs plain {kind} V={V} B={Bs}: state bit-equal over "
              f"5 blocks each, max |mix diff| so far {max_err:.3e}")
    return max_err


def trigger_stages(bank):
    """Every voice triggered once, in eventful blocks of event_capacity
    restart events at frame 0."""
    trig = bank.trig_index("t_restart")
    cap = bank.event_capacity
    V = bank.n_voices
    return [bank.node_events_from_lists(
                [(0, v, trig, 1, 0.0) for v in range(base, min(base + cap, V))])
            for base in range(0, V, cap)]


def reset_counts():
    for kind in ("sine", "fm", "sub", "wt", "generic"):
        kernel_module(kind).LAUNCHES = 0


def read_counts():
    return {kernel_module(k).KERNEL: kernel_module(k).LAUNCHES
            for k in ("sine", "fm", "sub", "wt", "generic")}


def phase_slice(torch, np, ktt, dev, kind, card, sustains):
    """The bank's benchmark sequence through its public API: every voice
    triggered through staged eventful blocks, then 750 event-free blocks.
    Returns (bank, final state, kernel launches, mix [750, C, B],
    render seconds, host enqueue seconds)."""
    ctx = ktt.AudioCtx(SR, BLOCK, torch.float32)
    capacity = 256 if kind == "sine" else SUITE_CAPACITY  # bench.py / suite.py
    bank = make_bank(ktt, np, kind, N_VOICES, capacity)
    state = bank.init(ctx, device=dev)
    stages = trigger_stages(bank)
    outs = torch.empty((N_BLOCKS, bank.voice.outputs, BLOCK), dtype=torch.float32,
                       device=dev)
    name = kernel_module(kind).KERNEL
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    for ev in stages:
        state, out = bank.process(ctx, state, events=ev)
    torch.cuda.synchronize()
    t_trigger = time.perf_counter() - t0
    n_sounding = int((state["stage"] != 0).sum())
    t0 = time.perf_counter()
    for b in range(N_BLOCKS):
        state, out = bank.process(ctx, state)
        outs[b].copy_(out)
    t_enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    counts = read_counts()

    if len(stages) != -(-N_VOICES // capacity):
        fail(f"{kind}: built {len(stages)} staged trigger blocks")
    launches = counts[name]
    if launches != len(stages) + N_BLOCKS:
        fail(f"{kind}: {name} launched {launches} times for "
             f"{len(stages) + N_BLOCKS} blocks")
    if any(n for k, n in counts.items() if k != name):
        fail(f"{kind}: other kernels launched during its slice: {counts}")
    if n_sounding != N_VOICES:
        fail(f"{kind}: only {n_sounding} of {N_VOICES} voices sound after triggering")
    if not bool(torch.isfinite(outs).all()):
        fail(f"{kind}: non-finite samples in the rendered mix")
    peak = float(outs.abs().max())
    if peak == 0.0:
        fail(f"{kind}: the rendered mix is silent")
    n_end = int((state["stage"] != 0).sum())
    if sustains and n_end != N_VOICES:
        fail(f"{kind}: only {n_end} voices still sound after the event-free render")
    # two more renders of the same length, after the counts were read: the
    # host's share of the wall time varies, so print the spread within
    # this call (the voices do the same work whether sounding or not)
    renders = [t_render]
    for _ in range(2):
        t0 = time.perf_counter()
        for b in range(N_BLOCKS):
            state, _ = bank.process(ctx, state)
        torch.cuda.synchronize()
        renders.append(time.perf_counter() - t0)
    rates = [N_VOICES * N_BLOCKS * BLOCK / t for t in renders]
    print(f"slice {kind}: {N_VOICES} voices, {len(stages)} trigger blocks in "
          f"{t_trigger:.3f} s, {N_BLOCKS} event-free blocks in {t_render:.4f} s "
          f"(host enqueue {t_enqueue:.4f} s), mix peak {peak:.4g}, launches "
          f"{launches}, {n_end} voices sounding at the end")
    print(f"slice {kind}: {rates[0]:.6g} voice-samples/s event-free "
          f"({rates[0] / (600 * SR):.1f}x the 600-voice reference) on {card}; "
          f"two more renders: {rates[1]:.6g}, {rates[2]:.6g}")
    return bank, state, launches, outs, t_render, t_enqueue


def profile_window(torch, label, run, n):
    """torch.profiler (CUPTI) over ``run()``, which renders ``n`` blocks.
    Prints the device-busy share of the profiled window and the kernels
    that fill it; the profiler's own host cost inflates the wall time, so
    the share is a lower bound on the unprofiled one. Returns (kernels a
    block, busy %), None each where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        print(f"profile {label}: the profiler recorded no device time (not measured)")
        return None, None
    per_block, share = sum(e.count for e in kernels) / n, 100 * busy_us / wall_us
    print(f"profile {label}: {n} event-free blocks, device busy "
          f"{busy_us / n:.2f} us/block of {wall_us / n:.2f} us/block wall under the "
          f"profiler ({share:.1f}% busy), {per_block:.1f} kernels/block")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / n:9.2f} us/block  x{e.count // n:<3d} "
              f"{e.key[:90]}")
    return per_block, share


def time_call(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_graph(torch, fn, reps):
    """Device ms a call of ``fn``: ``reps`` calls captured in one CUDA graph
    on a side stream (after a warm-up call there), the graph replayed once,
    then timed with CUDA events over one more replay. Unlike ``time_call``
    it leaves the host's launch rate out: the bank wrappers check their
    operands in Python, tens of microseconds a call, as long as a short
    kernel runs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tensor_bytes(*objs):
    """The bytes of every tensor in ``objs`` (dicts, tuples and lists
    walked)."""
    import torch

    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, dict):
            total += tensor_bytes(*o.values())
        elif isinstance(o, (tuple, list)):
            total += tensor_bytes(*o)
    return total


def bound(nbytes, nops):
    """(bound_ms, bound_by): the least time the card could take."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, nops / FP32_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def written(mod, outs):
    """A bank kernel's outputs without its mix scratch (the second buffer,
    ``bank_common.empty_mix``): what the bound counts as written once."""
    return (outs[0], *outs[2:])


def empty_outputs(mod, bank, operands):
    if mod.KERNEL == "generic_bank":
        return mod.empty_outputs(operands["carry"], bank.voice.outputs, BLOCK)
    first = next(operands[n] for n, _, _ in bank.STATE)
    return mod.empty_outputs(first, BLOCK)


def phase_timings(torch, ktt, kind, bank, state, card):
    """Kernel, wrapper and plain ms at V=131072, B=64, both variants."""
    ctx = ktt.AudioCtx(SR, BLOCK, torch.float32)
    mod = kernel_module(kind)
    plain = plain_of(mod)
    ops, _ = bank.kernel_operands(ctx, state, None)
    outs = empty_outputs(mod, bank, ops)
    ms = time_graph(torch, lambda: mod.launch(outs, **ops), 200)
    eager_ms = time_call(torch, lambda: mod.launch(outs, **ops), 200)
    wrapper_ms = time_call(torch, lambda: bank.kernel(**ops), 200)
    plain_ms = time_call(torch, lambda: plain(**ops), 1)
    cap = bank.event_capacity
    ev = bank.node_events_from_lists(schedule(bank, N_VOICES, BLOCK)[0][:cap])
    ev_ops, _ = bank.kernel_operands(ctx, state, ev)
    ev_ms = time_graph(torch, lambda: mod.launch(outs, **ev_ops), 100)
    ev_wrapper_ms = time_call(torch, lambda: bank.kernel(**ev_ops), 100)
    ev_plain_ms = time_call(torch, lambda: plain(**ev_ops), 1)
    per_sample = OPS_PER_SAMPLE.get(kind, OPS_PER_SAMPLE[mod.KERNEL])
    nbytes = tensor_bytes(ops, written(mod, outs))
    bound_ms, bound_by = bound(nbytes, per_sample * N_VOICES * BLOCK)
    general = ""
    if kind in HAND_KINDS or kind in USER_FLAT_PAN_OPS_PER_SAMPLE:
        # the bound is that of the path these inputs take; the general
        # count's beside it
        general = f"; at the general count ({per_sample}) {bound_ms:.4f} ms ({bound_by})"
        per_sample, hoisted = (hand_ops_per_sample(torch, mod, ops, BLOCK) if kind in HAND_KINDS
                               else user_ops_per_sample(torch, kind, ops, BLOCK))
        bound_ms, bound_by = bound(nbytes, per_sample * N_VOICES * BLOCK)
        general = f", {hoisted:.4f} of the warps on the hoisted path" + general
    graph_wrapper_ms = time_graph(torch, lambda: bank.kernel(**ops), 200)
    if kind == "fm":
        # the slice's final state has every voice stopped (EnvAr has no
        # sustain): the kernel also on a sounding one, every voice triggered
        # and four blocks rendered (tools/time_bank_kernel.py's state)
        s_ops, _ = bank.kernel_operands(ctx, sounding_state(torch, ktt, bank), None)
        s_ms = time_graph(torch, lambda: mod.launch(outs, **s_ops), 200)
        s_per, s_hoisted = hand_ops_per_sample(torch, mod, s_ops, BLOCK)
        s_bound, s_by = bound(nbytes, s_per * N_VOICES * BLOCK)
        print(f"timing {kind} V={N_VOICES} B={BLOCK} on {card}: event-free kernel at the "
              f"sounding state {s_ms:.4f} ms; bound {s_bound:.4f} ms ({s_by}, {s_per:g} f32 "
              f"operations a voice-sample, {s_hoisted:.4f} of the warps on the hoisted path)")
    print(f"timing {kind} V={N_VOICES} B={BLOCK} on {card}: event-free kernel "
          f"{ms:.4f} ms (eager {eager_ms:.4f} ms), wrapper {graph_wrapper_ms:.4f} ms "
          f"(eager {wrapper_ms:.4f} ms), plain {plain_ms:.3f} ms; eventful kernel "
          f"{ev_ms:.4f} ms, wrapper {ev_wrapper_ms:.4f} ms, plain {ev_plain_ms:.3f} ms; "
          f"bound {bound_ms:.4f} ms ({bound_by}, {per_sample:g} f32 operations a "
          f"voice-sample{general})")
    return ms, plain_ms, bound_ms, bound_by


def sounding_state(torch, ktt, bank):
    """A state of ``bank`` with its voices sounding: every voice triggered
    once (``trigger_stages``), then four event-free blocks."""
    ctx = ktt.AudioCtx(SR, BLOCK, torch.float32)
    state = bank.init(ctx, device=torch.device("cuda", 0))
    for ev in trigger_stages(bank):
        state, _ = bank.process(ctx, state, events=ev)
    for _ in range(4):
        state, _ = bank.process(ctx, state)
    return state


def hand_ops_per_sample(torch, mod, ops, B):
    """(f32 operations a voice-sample, share of warps on the hoisted path)
    of a hand kernel (sine, subtractive, FM) on the event-free ``ops``,
    counted from the data as the kernel decides by warp (its __all_sync over
    ``bank_common``'s flat and steady rules): FLAT_OPS_PER_SAMPLE on a warp
    whose every lane takes the hoisted path, QUIET_OPS_PER_SAMPLE on a warp
    of zero gains there (a sine warp advances its phases at once and sums
    nothing; an FM warp runs both phase recurrences and sums nothing),
    OPS_PER_SAMPLE on every other warp (one that takes some hoists is
    counted at the general count). The FM kernel's hoisted path is all four
    ramps flat (its envelope runs a sample), its quiet warps those whose
    envelopes are stopped and amps flat, whatever their other ramps."""
    from knaster_tpu_torch.kernels import bank_common as bc

    ramps, stage = ops["ramps"], ops["stage"]
    amp = ramps[mod.AMP].clone()
    bc.fold_act(amp, ops["act"])
    if mod.KERNEL == "fm_bank":
        fast = bc.ramp_flat_over_block(amp, B)
        quiet = fast & bc.env_ar_steady(stage) & (0.0 * bc._mat(0.0, amp) == 0)
        for p in (mod.FREQ, mod.RATIO, mod.INDEX):
            fast &= bc.ramp_flat_over_block(ramps[p], B)
    else:
        fast = bc.ramp_flat_over_block(amp, B) & bc.env_asr_steady(stage)
        quiet = torch.zeros_like(fast)
    if mod.KERNEL == "sine_bank":
        pack = bc.pan_pack(ramps[mod.PAN])
        fast &= bc.ramp_flat_over_block(ramps[mod.FREQ], B) & bc.pack_flat_over_block(pack, B)
        hl, hr = bc._pan_gains(0.0, pack)
        gain0 = torch.where(stage == 2, 1.0, 0.0) * bc._mat(0.0, amp)
        quiet = (gain0 == 0) & torch.isfinite(hl) & torch.isfinite(hr)
    elif mod.KERNEL == "sub_bank":
        for p in (mod.FREQ, mod.CUT, mod.Q):
            fast &= bc.ramp_flat_over_block(ramps[p], B)

    def by_warp(x):  # ragged lanes take every path
        pad = torch.ones((-x.numel()) % 32, dtype=torch.bool, device=x.device)
        return torch.cat([x, pad]).view(-1, 32).all(dim=1)

    quiet = by_warp(quiet)
    if mod.KERNEL == "sine_bank":
        quiet &= by_warp(fast)
    fast = by_warp(fast) & ~quiet
    n = fast.numel()
    flat, general = FLAT_OPS_PER_SAMPLE[mod.KERNEL], OPS_PER_SAMPLE[mod.KERNEL]
    n_fast, n_quiet = int(fast.sum()), int(quiet.sum())
    per_sample = (n_fast * flat + n_quiet * QUIET_OPS_PER_SAMPLE.get(mod.KERNEL, 0)
                  + (n - n_fast - n_quiet) * general) / n
    return per_sample, (n_fast + n_quiet) / n


def user_ops_per_sample(torch, kind, ops, B):
    """(f32 operations a voice-sample, share of warps on the hoisted path)
    of a stereo user body on the event-free ``ops``: the harness takes the
    pan gains once a block on a lane whose pan ramp is flat over it
    (csrc/bank_common.cuh ramp_flat), so a warp of such lanes does
    USER_FLAT_PAN_OPS_PER_SAMPLE and every other warp OPS_PER_SAMPLE (its
    lanes run the pan each sample)."""
    from knaster_tpu_torch.kernels import bank_common as bc

    pan = ops["ramps"][list(ops["float_names"]).index("pan")]
    flat = bc.ramp_flat_over_block(pan, B)
    flat = torch.cat([flat, torch.ones((-flat.numel()) % 32, dtype=torch.bool,
                                       device=flat.device)]).view(-1, 32).all(dim=1)
    n, n_flat = flat.numel(), int(flat.sum())
    per_sample = (n_flat * USER_FLAT_PAN_OPS_PER_SAMPLE[kind]
                  + (n - n_flat) * OPS_PER_SAMPLE[kind]) / n
    return per_sample, n_flat / n


# --------------------------------------------------------------------------
# the stage-loop kernels and the graph slices
# --------------------------------------------------------------------------

STAGE_KERNELS = ("fm_cascade", "chain_kernel", "pink_noise", "buffer_reader", "svf_filter",
                 "galactic", "env_asr")


def stage_module(name):
    from knaster_tpu_torch.kernels import (buffer_reader, chain_kernel, env_asr, fm_cascade,
                                           galactic, pink_noise, svf_filter)

    return {"fm_cascade": fm_cascade, "chain_kernel": chain_kernel,
            "pink_noise": pink_noise, "buffer_reader": buffer_reader,
            "svf_filter": svf_filter, "galactic": galactic, "env_asr": env_asr}[name]


def expect_ugen_kernels(counts, names, where):
    """The kernels of the UGens that run their own process (``names``) each
    launched, and no other kernel."""
    want = {k: counts.get(k, 0) for k in names}
    expect_counts(counts, want, where)
    if not all(want.values()):
        fail(f"{where}: kernels {want} (each must launch)")


def reset_all_counts():
    reset_counts()
    for name in STAGE_KERNELS:
        stage_module(name).LAUNCHES = 0
        getattr(stage_module(name), "LAUNCHES_BY_BLOCK", {}).clear()


def launch_tally():
    """The UGen kernels' launches by block length since the counts were
    reset (``LAUNCHES_BY_BLOCK``: the reader's by B, EnvAsr's by B and
    path), for those that launched."""
    return {name: dict(sorted(stage_module(name).LAUNCHES_BY_BLOCK.items()))
            for name in ("buffer_reader", "env_asr")
            if stage_module(name).LAUNCHES_BY_BLOCK}


def read_all_counts():
    counts = read_counts()
    for name in STAGE_KERNELS:
        counts[name] = stage_module(name).LAUNCHES
    return counts


def u32_near_top(torch, np, n, seed, dev):
    """n u32 phases within 2^26 of 2^32 (int32 bit patterns): the first
    increments wrap."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(2**32 - 2**26, 2**32, n, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(dev)


def build_cascade(kt, gg, n, handles=None, osc=None):
    """benchmarks/suite.py:374-399: n SinWt (or ``osc``) stages, each one's
    output FM-modulating the next one's freq through (prev * 100) + 200."""
    osc = osc or kt.SinWt
    prev = None
    for i in range(n):
        s = gg.push(osc(100.0 + i))
        if prev is not None:
            mod = (prev * 100.0) + 200.0
            gg.connect_param(gg.handle(mod.channels[0][1]), 0, s, "freq")
        prev = s
        if handles is not None:
            handles.append(s)
    (prev * 0.1).to_graph_out()


def offset_constant(gg, sine):
    """The Constant(200) node whose value is added to ``sine``'s modulator."""
    add = gg.param_edges[(sine.node_id, 0)].src
    return gg.handle(gg.in_edges[add][1][0].src)


# the fm_cascade kernel's block-rate params (freq, base, depth, amp): the
# benchmark's defaults; stage 0 saturating with every later stage negative;
# every later stage saturating
FM_PARAM_SETS = (
    ("defaults", (100.0, 200.0, 100.0, 0.1)),
    ("saturating stage 0, negative stages", (1.0e5, -300.0, 100.0, 0.1)),
    ("saturating stages", (100.0, 96500.0, 100.0, 0.1)),
)


def stage_consts(np):
    from knaster_tpu_torch.ugens.wavetable import FRACTIONAL_PART, TABLE_SIZE

    return (float(np.float32(TABLE_SIZE * FRACTIONAL_PART / SR)),
            float(np.float32(2.0 * np.pi / TABLE_SIZE)))


def cascade_clusters(mod, device, B):
    """Every layout ``mod.launch_plan`` can take at B on the card: one CTA
    where it holds the row, then a cluster of each size from 2 to the
    card's largest."""
    return ([1] if B <= mod.ONE_CTA_MAX else []) + list(
        range(2, mod.card_max_cluster(mod._load(), device) + 1))


def phase_fm_cascade_vs_plain(torch, np, dev, Ns=(16, CASCADE), Bs=None):
    """The fm_cascade kernel against its plain version over three blocks of
    each param set at every N and B (by default STAGE_BLOCKS, the longest
    superblock of a B = 64 render and the kernel's own limit), phases
    starting near the top of the u32 range, in the layout ``launch_plan``
    picks and forced into every layout (``cascade_clusters``; at the
    kernel's limit the planned one and the largest cluster); checks the
    saturation rule on the stage phases. Returns the max |output difference|
    it measured (0.0: bit-equal)."""
    mod = stage_module("fm_cascade")
    Bs = Bs or STAGE_BLOCKS + (CHUNK * BLOCK, mod.MAX_BLOCK)
    f2pi, scale = stage_consts(np)
    err = 0.0
    for N in Ns:
        for B in Bs:
            clusters = cascade_clusters(mod, dev, B)
            forced = [None] + (clusters if B < mod.MAX_BLOCK else clusters[-1:])
            for label, vals in FM_PARAM_SETS:
                params = torch.tensor(vals, dtype=torch.float32, device=dev)
                ph = u32_near_top(torch, np, N, N + B, dev)
                for blk in range(3):
                    pp = ph.clone()
                    op = mod.fm_cascade_plain(params=params, phases=pp, block_size=B,
                                              f2pi=f2pi, scale=scale)
                    for C in forced:
                        pk = ph.clone()
                        ok = torch.empty((B,), dtype=torch.float32, device=dev)
                        plan = mod.launch(ok, params=params, phases=pk, block_size=B,
                                          f2pi=f2pi, scale=scale, cluster=C)
                        torch.cuda.synchronize()
                        where = (f"fm_cascade N={N} B={B} {label} block {blk} "
                                 f"({'planned, ' if C is None else ''}cluster {plan.cluster})")
                        if not torch.equal(pk, pp):
                            fail(f"{where}: phases differ from the plain version in "
                                 f"{int((pk != pp).sum())} stages")
                        err = max(err, float((ok - op).abs().max()))
                        if not torch.equal(bits(ok), bits(op)):
                            fail(f"{where}: output differs from the plain version by {err}")
                    if not bool(torch.isfinite(op).all()) or float(op.abs().max()) == 0.0:
                        fail(f"fm_cascade N={N} B={B} {label} block {blk}: output not "
                             "finite or silent")
                    step = (pp.long() - ph.long()) % 2**32
                    if label.startswith("saturating stage 0") and (
                            int(step[0]) != (B * (2**31 - 1)) % 2**32
                            or bool((step[1:] != 0).any())):
                        fail(f"fm_cascade N={N} B={B}: stage 0 must advance 2^31 - 1 per "
                             "sample and the negative stages not at all")
                    if label == "saturating stages" and int(step[-1]) != (B * (2**31 - 1)) % 2**32:
                        fail(f"fm_cascade N={N} B={B}: a saturating stage must advance "
                             "2^31 - 1 per sample")
                    ph = pp
        print(f"kernel vs plain fm_cascade N={N} B={Bs}: phases and output bit-equal "
              f"over 3 blocks of {len(FM_PARAM_SETS)} param sets, in the planned layout "
              f"and forced to one CTA and to clusters of 2 to {clusters[-1]} (at "
              f"{mod.MAX_BLOCK} the largest)")
    return err


def capture_chain(torch, proc):
    """The chain kernel's operands on the processor's main path: one
    event-free block of the compiled graph (not kept), with the wrapper
    wrapped to record what it is given."""
    kck = stage_module("chain_kernel")
    real, got = kck.chain_kernel, []

    def spy(program, **operands):
        got.append((program, operands))
        return real(program, **operands)

    kck.chain_kernel = spy
    try:
        proc._ensure_compiled()
        proc.compiled.render_fast(proc.state, proc._zero_inputs())
    finally:
        kck.chain_kernel = real
    if len(got) != 1:
        fail(f"expected one chain kernel call per block, saw {len(got)}")
    return got[0]


def chain_graph(kt, dev, n, B, tap):
    """The cascade of n stages as graph nodes on ``dev`` (with a mid-chain
    tap when ``tap``), one stage's offset constant set to saturate its
    oscillator and another's to make its frequency negative; returns the
    processor after one eventful block."""
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=B),
                                    device=dev)
    hs = []

    def build(gg):
        build_cascade(kt, gg, n, hs)
        if tap:
            (hs[7] * 0.05).to_graph_out()

    g.edit(build)
    offset_constant(g, hs[n // 2]).param("value").set(96500.0)
    offset_constant(g, hs[n // 3]).param("value").set(-500.0)
    proc.render(frames=B, fetch=False)  # the eventful block (scan executor)
    return proc


def phase_chain_vs_plain(torch, np, kt, dev, Bs=(16, 64, 1024)):
    """The chain kernel against its plain version on the lowered plans of
    the 256-stage cascade and of a 14-stage cascade with a mid-chain tap,
    at every B, from the graph's own state and from phases near the top of
    the u32 range. Returns the max |output difference| it measured."""
    kck = stage_module("chain_kernel")
    err = 0.0
    for n, tap in ((CASCADE, False), (14, True)):
        for B in Bs:
            proc = chain_graph(kt, dev, n, B, tap)
            program, ops = capture_chain(torch, proc)
            K = ops["K"]
            for label, state in (("graph state", ops["state"]),
                                 ("phases near 2^32",
                                  u32_near_top(torch, np, K, n + B, dev)
                                  .reshape(ops["state"].shape))):
                where = f"chain_kernel {n} stages B={B} {label}"
                err = max(err, compare_chain(torch, kck, program, dict(ops, state=state),
                                             where)[0])
        print(f"kernel vs plain chain_kernel {n} stages (p={program.period}, "
              f"{program.n_out} out planes) B={Bs}: state and outputs bit-equal")
    return err


def body_chain(kt, ops):
    """A 9-sine cascade whose stage passes the modulator through three
    Math1 ops and a Math sub and div (tests/test_torch_chain_kernel.py)."""
    def build(gg):
        prev = None
        for i in range(9):
            s = gg.push(kt.SinWt(100.0 + 3 * i))
            if prev is not None:
                x = prev + 1.5
                for op in ops:
                    u = gg.push(kt.Math1UGen(op))
                    x.to(u)
                    x = u
                mod = (((x - 0.25) / 2.0) * 100.0) + 200.0
                gg.connect_param(gg.handle(mod.channels[0][1]), 0, s, "freq")
            prev = s
        (prev * 0.1).to_graph_out()
    return build


BODY_OPS = (("abs", "sqrt", "log"), ("exp", "sin", "cos"), ("tanh", "neg", "ceil"),
            ("floor", "neg", "abs"))


def phase_bodies_vs_plain(torch, kt, dev):
    """Every Math and Math1 body of the chain kernel against the plain
    version on the card, B = 64: state and outputs bit-equal. Returns the
    max |output difference| it measured."""
    kck = stage_module("chain_kernel")
    err = 0.0
    for ops in BODY_OPS:
        g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=BLOCK),
                                        device=dev)
        g.edit(body_chain(kt, ops))
        proc.render(frames=4 * BLOCK, fetch=False)
        program, run = capture_chain(torch, proc)
        err = max(err, compare_chain(torch, kck, program, run,
                                     f"chain_kernel bodies {ops}")[0])
    print(f"kernel vs plain chain_kernel bodies add/sub/mul/div and "
          f"{sorted({o for ops in BODY_OPS for o in ops})} in 9-sine chains, B={BLOCK}: "
          "state and outputs bit-equal")
    return err


# --------------------------------------------------------------------------
# the subtractive slice: PolyBlep, SvfFilter, the one-poles, the envelopes
# and Pan2 on the chain kernel
# --------------------------------------------------------------------------

# ISO 266 1/3-octave centres, 20 Hz to 20 kHz
ISO_THIRDS = (20.0, 25.0, 31.5, 40.0, 50.0, 63.0, 80.0, 100.0, 125.0, 160.0, 200.0,
              250.0, 315.0, 400.0, 500.0, 630.0, 800.0, 1000.0, 1250.0, 1600.0, 2000.0,
              2500.0, 3150.0, 4000.0, 5000.0, 6300.0, 8000.0, 10000.0, 12500.0,
              16000.0, 20000.0)


def polyblep_cascade(kt, gg, n=CASCADE):
    """benchmarks/suite.py:1247-1255's wiring with PolyBlep stages: each
    stage's output * 100 + 200 drives the next stage's freq; the waveforms
    cycle through Sawtooth, Square, Triangle, Rectangle and
    TrapezoidVariable, the last two with a pulse width of 0.3."""
    W = kt.Waveform
    waves = (W.Sawtooth, W.Square, W.Triangle, W.Rectangle, W.TrapezoidVariable)
    prev = None
    for i in range(n):
        s = gg.push(kt.PolyBlep(waves[i % len(waves)], 100.0 + i))
        if i % len(waves) >= 3:
            s.param("pulse_width").set(0.3)
        if prev is not None:
            mod = (prev * 100.0) + 200.0
            gg.connect_param(gg.handle(mod.channels[0][1]), 0, s, "freq")
        prev = s
    (prev * 0.1).to_graph_out()


def graphic_eq_31(kt, gg):
    """A PolyBlep saw at 110 Hz into a 31-band 1/3-octave graphic EQ: 31
    SvfFilter(Bell) in series at the ISO 266 centres, q = 4.32, gains
    alternating +6 / -6 dB."""
    node = gg.push(kt.PolyBlep(kt.Waveform.Sawtooth, 110.0))
    for i, fc in enumerate(ISO_THIRDS):
        f = gg.push(kt.SvfFilter(kt.SvfFilterType.Bell, fc, q=4.32,
                                 gain_db=6.0 if i % 2 == 0 else -6.0))
        node.to(f)
        node = f
    (node * 0.25).to_graph_out()


def onepole_chain(kt, gg, noise=False):
    """tests/test_chain_kernel.py:142: 16 one-poles alternating Lpf / Hpf
    (period 2) and a last Hpf, from a PolyBlep saw (or, as the JAX test
    builds it, a WhiteNoise)."""
    node = gg.push(kt.WhiteNoise(seed=7) if noise
                   else kt.PolyBlep(kt.Waveform.Sawtooth, 220.0))
    for i in range(16):
        f = gg.push(kt.OnePoleLpf(8000.0 + 100.0 * i) if i % 2 == 0
                    else kt.OnePoleHpf(40.0 + 5.0 * i))
        node.to(f)
        node = f
    hp = gg.push(kt.OnePoleHpf(50.0))
    node.to(hp)
    hp.to_graph_out()


def env_chain(env_cls, done_action=None):
    """tests/test_chain_kernel.py:265-318 and :355: ten envelopes mixed
    serially (env_i + the running sum), a period-2 (envelope, Math add)
    chain, each envelope with its own off-grid times."""
    def build(kt, gg):
        prev = None
        for i in range(10):
            e = env_cls(attack_time=(50.3 + 7.1 * i) / SR,
                        release_time=(95.5 + 3.0 * i) / SR)
            e = gg.push(e) if done_action is None else gg.push_with_done_action(
                e, done_action)
            prev = e if prev is None else prev + e
        (prev * 0.05).to_graph_out()
    return build


def pan2_chain(kt, gg, noise=False):
    """tests/test_chain_kernel.py:431: ten Pan2 stages, stereo folded back
    to mono between them, from a PolyBlep square (or a WhiteNoise)."""
    prev = gg.push(kt.WhiteNoise(seed=3) if noise
                   else kt.PolyBlep(kt.Waveform.Square, 330.0))
    for i in range(10):
        p = gg.push(kt.Pan2(-0.4 + 0.08 * i))
        prev.to(p)
        prev = p.out([0]) + p.out([1])
    (prev * 0.1).to_graph_out()


def phasor_cascade(kt, gg):
    """tests/test_chain_kernel.py:209-232: 12 Phasor LFOs, each one's output
    * 40 + 60 driving the next one's freq."""
    prev = None
    for i in range(12):
        ph = gg.push(kt.Phasor(0.5 + 0.25 * i))
        if prev is not None:
            mod = (prev * 40.0) + 60.0
            gg.connect_param(gg.handle(mod.channels[0][1]), 0, ph, "freq")
        prev = ph
    (prev * 0.2).to_graph_out()


def sin_numeric_cascade(kt, gg):
    """build_cascade's 256-stage FM wiring (benchmarks/suite.py:374-399)
    with SinNumeric stages: a float phase in every stage."""
    build_cascade(kt, gg, CASCADE, osc=kt.SinNumeric)


def float_osc_paths(kt):
    """The param-sweep slice's chains, on the SinNumeric and Phasor bodies."""
    return {"phasor_cascade": phasor_cascade, "sin_numeric_cascade": sin_numeric_cascade}


def chain_paths(kt):
    """The graphs whose chains run the new bodies: name -> builder."""
    return {
        "polyblep_cascade": polyblep_cascade,
        "graphic_eq_31": graphic_eq_31,
        "onepole_chain": onepole_chain,
        "env_asr_chain": env_chain(kt.EnvAsr),
        "env_asr_free_parent": env_chain(kt.EnvAsr, kt.Done.FREE_PARENT),
        "env_ar_chain": env_chain(kt.EnvAr),
        "pan2_chain": pan2_chain,
    }


def restart_envelopes(g):
    """Trigger every envelope of the graph now (an eventful block)."""
    for nid, e in list(g.nodes.items()):
        if "t_restart" in e.ugen.param_names():
            g.handle(nid).param("t_restart").trig()


def restarted_processor(torch, kt, dev, build, B):
    """A processor at block size ``B`` for the graph of ``build``, its state
    and clock those after one eventful block of BLOCK samples that restarts
    every envelope and applies the initial sets. That block renders at
    BLOCK whatever B is: an eventful block runs the envelopes' per-sample
    loop on the eager scan executor, ~30 s at 8192 samples for a chain of
    nine envelopes."""
    from knaster_tpu_torch.graph.compile import _shapes
    from knaster_tpu_torch.graph.processor import copy_state

    g0, proc0 = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=BLOCK),
                                      device=dev)
    g0.edit(lambda gg: build(kt, gg))
    restart_envelopes(g0)
    proc0.render(frames=BLOCK, fetch=False)
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=B), device=dev)
    g.edit(lambda gg: build(kt, gg))
    proc._ensure_compiled()
    if _shapes(proc.state) != _shapes(proc0.state):
        fail(f"the graph's state at B={B} is not laid out as at B={BLOCK}")
    proc.state = copy_state(proc0.state)
    g.clock.frames = g0.clock.frames
    return proc


def records_of(program, body):
    """[(stage-record index, record)] of a program's records of one body."""
    return [(i, r) for i, r in enumerate(program.records()) if r[0].name == body]


def edge_operands(torch, np, kck, program, ops, B, seed):
    """The captured operands with the state and planes moved to the edges:
    phases within 2^26 of 2^32; one SVF stage's cutoff at 23,900 Hz (just
    under Nyquist) and random filter state; envelope stages cycling through
    an attack that crosses 1 mid-block, a release that ends mid-block,
    sustain and stopped for EnvAsr, and an attack that crosses and then a
    release that ends in the same block for EnvAr; WhiteNoise frames within
    2^10 of 2^32 (the block's frames wrap) under the seed 2^32 - 1;
    SampleDelay rings of random samples written up to L - 1 (pos = L - 1),
    the stages' delays cycling through 0, L - 1, beyond L (clamped to L -
    1) and a per-sample ramp from 0 to L - 1."""
    rng = np.random.default_rng(seed)
    K = ops["K"]
    state = ops["state"].clone()
    planes = ops["planes"].clone()
    dev = state.device

    def set_plane(src, k, value):
        if src[0] == kck.SRC_PLANE:
            planes[src[1], k] = value

    def f32_words(x):
        return torch.from_numpy(np.asarray(x, np.float32).view(np.int32)).to(dev)

    for name in ("polyblep", "sinwt"):
        for _, rec in records_of(program, name):
            state[rec[5]] = u32_near_top(torch, np, K, seed, dev)
    for _, rec in records_of(program, "svf"):
        set_plane(rec[3][1], K // 2, 23900.0)
        state[rec[5]:rec[5] + 2] = f32_words(rng.uniform(-0.5, 0.5, (2, K)))
    for body in ("sin_numeric", "phasor"):
        for _, rec in records_of(program, body):
            # f32 phases just under the wrap at 1.0
            state[rec[5]] = f32_words(1.0 - rng.uniform(0.0, 1e-4, K))
    for _, rec in records_of(program, "white_noise"):
        frames = 2**32 - rng.integers(1, 2**10, K, dtype=np.int64)
        state[rec[5]] = torch.from_numpy(frames.astype(np.uint32).view(np.int32)).to(dev)
        state[rec[5] + 1] = -1  # the seed 2^32 - 1
    for _, rec in records_of(program, "sample_delay"):
        srow, L = rec[5], rec[1]
        state[srow:srow + L] = f32_words(rng.uniform(-1.0, 1.0, (L, K)))
        state[srow + L] = L - 1
        for k in range(K):
            set_plane(rec[3][0], k, (
                0.0, (L - 0.5) / SR, (L + 3.0) / SR,
                torch.linspace(0.0, (L - 0.5) / SR, B, device=dev))[k % 4])
    for body in ("env_asr", "env_ar"):
        for _, rec in records_of(program, body):
            srow = rec[5]
            for k in range(K):
                # rate 1/(B/2) attack from t = 0.5: crosses at ~B/4; rate
                # 2/B release from 1 (EnvAr) ends at ~3B/4, from 0.5 at ~B/4
                set_plane(rec[3][0], k, (B / 2.0) / SR * (1.0 + 0.01 * k))
                set_plane(rec[3][1], k, (B / 2.0) / SR * (1.0 + 0.013 * k))
                stage = (1, 3, 2, 0)[k % 4] if body == "env_asr" else (1, 3)[k % 2]
                words = f32_words([rng.uniform(0.5, 1.0), 0.0, 0.5])
                words[1] = stage
                state[srow:srow + 3, k] = words
    return dict(ops, state=state, planes=planes)


def compare_chain(torch, kck, program, run, where, global_rows=False, cluster=None,
                  plain=None):
    """Kernel against plain on one set of operands: outputs, state words and
    done rows bit-equal. ``global_rows=True`` launches the kernel with its
    rows in the global workspace whatever their length, ``cluster`` with
    that cluster size (``kck.launch_plan``); ``plain`` is the plain
    version's result on ``run`` when the caller has it. Returns (max
    |output difference|, the kernel's done rows)."""
    outs = kck.empty_outputs(program, run["state"].device, run["K"], run["block_size"])
    plan = kck.launch(outs, program, global_rows=global_rows, cluster=cluster, **run)
    where = f"{where} ({plan.layout}, cluster {plan.cluster})"
    ok, sk, dk = outs
    op, sp, dp = plain if plain is not None else kck.chain_kernel_plain(program, **run)
    torch.cuda.synchronize()
    err = float((ok - op).abs().max()) if ok.numel() else 0.0
    if not torch.equal(sk, sp):
        fail(f"{where}: state differs from the plain version in "
             f"{int((sk != sp).sum())} words")
    if not torch.equal(bits(ok), bits(op)):
        fail(f"{where}: outputs differ from the plain version by {err} in "
             f"{int((bits(ok) != bits(op)).sum())} samples")
    if not torch.equal(dk, dp):
        fail(f"{where}: done rows differ from the plain version in "
             f"{int((dk != dp).sum())} samples")
    if not bool(torch.isfinite(ok).all()):
        fail(f"{where}: non-finite outputs")
    return err, dk


# 96 blocks of 64: a launch whose cluster chunks (768 samples at C = 8) are
# not a power of two
NPOT_LEN = 96 * BLOCK


def forced_clusters(kck, program, B, device):
    """Every cluster size ``kck.launch_plan`` can take at B on the card: 1
    (one CTA, shared rows) where the rows fit one CTA, then
    ``kck.cluster_sizes`` up to the card's largest cluster."""
    one = [1] if kck.smem_bytes(program, B, 0) <= kck.SMEM_LIMIT else []
    return one + kck.cluster_sizes(program, B, kck.card_max_cluster(kck._load(), device))


def compare_layouts(torch, kck, program, run, where, forced=False):
    """``compare_chain`` under the layout ``kck.launch_plan`` picks and,
    with ``forced``, under every cluster size it can pick (one plain run
    for all). Returns (max |output difference|, the plan's done rows, the
    layouts compared)."""
    plain = kck.chain_kernel_plain(program, **run)
    err, dk = compare_chain(torch, kck, program, run, where, plain=plain)
    B, device = run["block_size"], run["state"].device
    plan = kck.launch_plan(program, B, run["K"],
                           max_cluster=kck.card_max_cluster(kck._load(), device))
    seen = [f"{plan.layout} {plan.cluster}"]
    if forced:
        for C in forced_clusters(kck, program, B, device):
            err = max(err, compare_chain(torch, kck, program, run, f"{where} forced",
                                         cluster=C, plain=plain)[0])
            seen.append(f"C={C}")
    return err, dk, seen


def phase_subtractive_vs_plain(torch, np, kt, dev, names=None, Bs=STAGE_BLOCKS, paths=None):
    """The chain kernel against its plain version on the lowered programs of
    the subtractive slice's chains (or of ``paths``), at every B and at the
    longest superblock each path's render takes, from the graph's own state
    (after an eventful block of BLOCK samples that restarts the envelopes
    and applies the initial sets, ``restarted_processor``) and from the edge
    state. Returns {chain: the max |output difference| it measured}."""
    kck = stage_module("chain_kernel")
    errs = {}
    for name, build in (paths or chain_paths(kt)).items():
        if names is not None and name not in names:
            continue
        dones, errs[name], layouts = 0, 0.0, set()
        # and at the longest superblock the path's render takes (under
        # every cluster size too) and at NPOT_LEN
        sb = superblock_len(kt, dev, build)[0]
        for B in Bs + (sb, NPOT_LEN):
            proc = restarted_processor(torch, kt, dev, build, B)
            program, ops = capture_chain(torch, proc)
            for label, run in (("graph state", ops),
                               ("edge state", edge_operands(torch, np, kck, program, ops, B,
                                                            B + program.n_state))):
                err, dk, seen = compare_layouts(torch, kck, program, run,
                                                f"chain_kernel {name} B={B} {label}",
                                                forced=B == sb)
                errs[name] = max(errs[name], err)
                dones += int(dk.sum())
                layouts.update(seen)
        bodies = sorted({r[0].name for r in program.records()})
        print(f"kernel vs plain chain_kernel {name} (K={ops['K']}, p={program.period}, "
              f"bodies {bodies}, {program.n_done} done planes) B={Bs}, {sb} and {NPOT_LEN} "
              f"(layouts {sorted(layouts)}): state, outputs and done rows bit-equal; "
              f"{dones} done samples compared set")
        if program.n_done and not dones:
            fail(f"chain_kernel {name}: no done row was set in any compared block")
    return errs


def superblock_len(kt, dev, build):
    """(the longest superblock, in samples, the graph's render takes at B =
    64: 64 m for the largest power of two m up to the render chunk within
    the graph's cap; the cap, in samples)."""
    from knaster_tpu_torch.graph.compile import superblock_eligible

    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=BLOCK),
                                    device=dev)
    g.edit(lambda gg: build(kt, gg))
    proc._ensure_compiled()
    if not superblock_eligible(proc.compiled):
        fail("a chain slice's graph is not superblock-eligible")
    cap, m = proc.compiled.superblock_max, CHUNK
    while m > 1 and m * BLOCK > cap:
        m //= 2
    return m * BLOCK, cap


def phase_float_osc_vs_plain(torch, np, kt, dev):
    """The chain kernel's SinNumeric and Phasor bodies against the plain
    version on the lowered programs of the 12-stage Phasor LFO cascade and
    the 256-stage SinNumeric FM cascade, at B in STAGE_BLOCKS and at the
    longest superblock their renders take (8192 samples, whose rows take
    the global workspace), from the graph's state after one block and from
    phases just under the wrap: state words and outputs bit-equal. Returns
    ({path: max |output difference|}, {path: superblock length})."""
    kck = stage_module("chain_kernel")
    errs, lengths = {}, {}
    for name, build in float_osc_paths(kt).items():
        sb, _cap = superblock_len(kt, dev, build)
        lengths[name], errs[name], layouts = sb, 0.0, set()
        Bs = STAGE_BLOCKS + (sb, NPOT_LEN)
        for B in Bs:
            g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=B),
                                            device=dev)
            g.edit(lambda gg: build(kt, gg))
            proc.render(frames=B, fetch=False)
            program, ops = capture_chain(torch, proc)
            for label, run in (("graph state", ops),
                               ("phases at the wrap",
                                edge_operands(torch, np, kck, program, ops, B, B + 1))):
                err, _, seen = compare_layouts(torch, kck, program, run,
                                               f"chain_kernel {name} B={B} {label}",
                                               forced=B == sb)
                errs[name] = max(errs[name], err)
                layouts.update(seen)
        print(f"kernel vs plain chain_kernel {name} (K={ops['K']}, p={program.period}, "
              f"bodies {sorted({r[0].name for r in program.records()})}) B={Bs} (the "
              f"longest superblock {sb}; layouts {sorted(layouts)}): state and outputs "
              "bit-equal")
    return errs, lengths


# --------------------------------------------------------------------------
# the FDN + Galactic slice: the WhiteNoise and SampleDelay bodies, the
# global-row path, the delays and Galactic in graphs
# --------------------------------------------------------------------------

PRIMES = (1031, 1327, 1523, 1871)  # examples/fdn_reverb.py's loop lengths
HADAMARD = ((1, 1, 1, 1), (1, -1, 1, -1), (1, 1, -1, -1), (1, -1, -1, 1))
ECHO = 32  # tests/test_chain_kernel.py:455's SampleDelay ring, in samples
ECHO_LONG = 2048  # a ring longer than the 1024-sample block
FDN_FRAMES = SR  # the golden render's 1 s
# the frames rendered on the CPU to hold the card's render against: the
# CPU renders the FDN at ~0.1x realtime; the fixture holds the whole second
FDN_CPU_FRAMES = SR // 4
GALACTIC_FRAMES = SR // 2  # galactic_chain's 1 s cut to 0.5 s
# the blocks whose launches are counted: every FDN block renders through the
# eager path (~1,200 launches), which the profiler is slow to collect
FDN_PROFILE = 16
GOLDEN_GATE = 1e-6 + 2.0 ** -23  # tests/golden_configs.py check_fixture at 24 bits


def noise_chain(kt, gg):
    """tests/test_chain_kernel.py:570-597: 12 units of a WhiteNoise summed
    into the running signal and a OnePoleLpf."""
    prev = None
    for i in range(12):
        n = gg.push(kt.WhiteNoise(seed=100 + i))
        lp = gg.push(kt.OnePoleLpf(2000.0 + 100.0 * i))
        (n if prev is None else prev + n).to(lp)
        prev = lp
    (prev * 0.2).to_graph_out()


def echo_chain(ring=ECHO):
    """tests/test_chain_kernel.py:455-483: WhiteNoise into ten
    SampleDelay(ring samples) * 0.8 stages, the delays 3 + 2 i samples, one
    of them smoothed (a per-sample delay ramp once a later set lands)."""
    def build(kt, gg):
        prev = gg.push(kt.WhiteNoise(seed=9))
        for i in range(10):
            d = gg.push(kt.SampleDelay(ring / SR))
            d.param("delay_time").set((3.0 + 2.0 * i) / SR)
            if i == 4:
                d.param("delay_time").smooth(kt.Smoothing.linear(20.0 / SR))
            prev.to(d)
            prev = d * 0.8
        (prev * 0.5).to_graph_out()
    return build


def sample_delay_cascade(kt, gg):
    """The benchmarks/suite.py:374-399 cascade wiring with SampleDelay
    stages: a WhiteNoise through 256 SampleDelay(10 ms), stage i delayed 3 +
    2 (i mod 200) samples."""
    prev = gg.push(kt.WhiteNoise(seed=5))
    for i in range(CASCADE):
        d = gg.push(kt.SampleDelay(0.01))
        d.param("delay_time").set((3.0 + 2.0 * (i % 200)) / SR)
        prev.to(d)
        prev = d
    (prev * 0.5).to_graph_out()


def noise_delay_paths(kt):
    """The chains that run the WhiteNoise and SampleDelay bodies."""
    return {"noise_chain": noise_chain, "echo_chain": echo_chain(),
            "echo_chain_long_ring": echo_chain(ECHO_LONG),
            "noise_onepole_chain": lambda kt_, gg: onepole_chain(kt_, gg, noise=True),
            "noise_pan2_chain": lambda kt_, gg: pan2_chain(kt_, gg, noise=True),
            "sample_delay_cascade": sample_delay_cascade}


def build_fdn(kt, gg, block_size=BLOCK):
    """examples/fdn_reverb.py:37-85 (golden fdn_galactic,
    tests/golden_configs.py:172-184): a WhiteNoise(seed=17) burst under an
    EnvAr into four long AllpassDelays at prime loop lengths, each damped by
    a OnePoleLpf at 5200 Hz, mixed back through a Hadamard matrix (g =
    0.85) over feedback edges, the stereo taps through Galactic. Returns
    the burst's restart trigger."""
    env = gg.push(kt.EnvAr(0.004, 0.05))
    burst = gg.push(kt.WhiteNoise(seed=17)) * env * 0.8
    delays, damped = [], []
    for n in PRIMES:
        d = gg.push(kt.AllpassDelay(
            kt.Seconds.from_samples(2 * n, SR), long=True,
            min_delay_time=kt.Seconds.from_samples(min(PRIMES) - block_size, SR)))
        d.param("delay_time").set(kt.Seconds.from_samples(n - block_size, SR).to_secs_f64())
        burst.to(d)
        lp = gg.push(kt.OnePoleLpf(5200.0))
        d.to(lp)
        delays.append(d)
        damped.append(lp)
    for i in range(4):
        mix = None
        for j in range(4):
            term = damped[j] * (0.85 * 0.5 * HADAMARD[i][j])
            mix = term if mix is None else mix + term
        mix.to_feedback(delays[i])
    gal = gg.push(kt.Galactic(replace=0.25, brightness=0.6, bigness=0.7, wet=0.35))
    ((damped[0] + damped[2]) * 0.35 | (damped[1] + damped[3]) * 0.35).to(gal)
    gal.to_graph_out()
    return env.param("t_restart")


def galactic_chain(kt, gg):
    """benchmarks/suite.py:475-498: PinkNoise into a long
    AllpassFeedbackDelay (0.25 s, feedback 0.5, min 0.25 s), both channels
    into Galactic(wet=0.5)."""
    src = gg.push(kt.PinkNoise())
    echo = gg.push(kt.AllpassFeedbackDelay(0.25, feedback=0.5, long=True,
                                           min_delay_time=0.25))
    verb = gg.push(kt.Galactic(wet=0.5))
    src.to(echo)
    echo.out([0, 0]).to(verb)
    verb.to_graph_out()


def read_fixture(name):
    """A golden fixture (tests/golden/<name>.flac) through the port's codec
    (``knaster_tpu_torch/utils/codec.py``, which builds
    native/knaster_flac.cpp at first use): (data [channels, frames] f32,
    sample rate)."""
    from knaster_tpu_torch.utils.codec import read_sound_file

    return read_sound_file(os.path.join(ROOT, "tests", "golden", f"{name}.flac"))


def tile_operands(torch, ops, n):
    """A captured chain block's operands stretched to ``n`` times its
    length: every plane and row repeated along time (the program does not
    depend on the length)."""
    return dict(ops, planes=ops["planes"].repeat(1, 1, n), rows=ops["rows"].repeat(1, n),
                block_size=ops["block_size"] * n)


# the lengths the global-row path is held at: one 128-block render chunk
# at B = 64 and at B = 1024
GLOBAL_ROW_LENGTHS = (CHUNK * BLOCK, CHUNK * 1024)


def slice_operands(ops, n):
    """A captured chain block's operands cut to its first ``n`` samples."""
    return dict(ops, planes=ops["planes"][..., :n].contiguous(),
                rows=ops["rows"][:, :n].contiguous(), block_size=n)


# a cluster no card schedules: past the non-portable 16
REFUSED_CLUSTER = 32


def phase_global_rows_vs_plain(torch, np, kt, dev, card):
    """The chain kernel's layouts against the plain version on the 256-stage
    FM cascade and on the Phasor and SinNumeric cascades, their programs
    captured at B = 64 and their operands stretched to 128 x 64 and 128 x
    1024 samples, from the graph's state and from phases near the wrap:
    with its rows forced into the global workspace, under the layout
    ``launch_plan`` picks and, at 128 x 64, under every cluster size; the
    FM cascade also at 61 and 8191 samples (rows a bulk copy cannot take,
    and no cluster at 8191). State words and outputs bit-equal. A cluster
    of REFUSED_CLUSTER CTAs must raise by name. Prints each length's plan
    and the FM cascade's time at the longer one. Returns {path: max |output
    difference|}."""
    kck = stage_module("chain_kernel")
    paths = {"fm_cascade": lambda kt_, gg: build_cascade(kt_, gg, CASCADE),
             **float_osc_paths(kt)}
    errs = {}
    for name, build in paths.items():
        g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=BLOCK),
                                        device=dev)
        g.edit(lambda gg: build(kt, gg))
        proc.render(frames=BLOCK, fetch=False)
        program, ops = capture_chain(torch, proc)
        edge = edge_operands(torch, np, kck, program, ops, BLOCK, 3)
        errs[name], placed = 0.0, []
        for n in GLOBAL_ROW_LENGTHS:
            layouts = set()
            for label, run in (("graph state", ops), ("edge state", edge)):
                run = tile_operands(torch, run, n // BLOCK)
                where = f"chain_kernel {name} {n} samples {label}"
                plain = kck.chain_kernel_plain(program, **run)
                errs[name] = max(errs[name], compare_chain(
                    torch, kck, program, run, where, global_rows=True, plain=plain)[0])
                err, _, seen = compare_layouts(torch, kck, program, run, where,
                                               forced=n == CHUNK * BLOCK)
                errs[name] = max(errs[name], err)
                layouts.update(seen)
            placed.append(f"{n}: {sorted(layouts)}")
        line = (f"kernel vs plain chain_kernel {name} (K={ops['K']}, p={program.period}) at "
                f"{GLOBAL_ROW_LENGTHS}, global rows and {'; '.join(placed)}: state and "
                "outputs bit-equal")
        if name == "fm_cascade":
            for n in (61, CHUNK * BLOCK - 1):
                for label, run in (("graph state", ops), ("edge state", edge)):
                    run = slice_operands(tile_operands(torch, run, CHUNK), n)
                    errs[name] = max(errs[name], compare_layouts(
                        torch, kck, program, run, f"chain_kernel {name} {n} samples {label}")[0])
            line += "; at 61 and 8191 samples too"
            run = tile_operands(torch, ops, CHUNK)
            outs = kck.empty_outputs(program, dev, run["K"], run["block_size"])
            try:
                kck.launch(outs, program, cluster=REFUSED_CLUSTER, **run)
                torch.cuda.synchronize()
                fail(f"chain_kernel: a cluster of {REFUSED_CLUSTER} launched")
            except RuntimeError as e:
                if "cudaError" not in str(e):
                    fail(f"chain_kernel: a refused cluster raised without its name: {e}")
                line += f"; a cluster of {REFUSED_CLUSTER} refused: {str(e)[:160]}"
            run = tile_operands(torch, ops, GLOBAL_ROW_LENGTHS[1] // BLOCK)
            outs = kck.empty_outputs(program, dev, run["K"], run["block_size"])
            ms = time_call(torch, lambda: kck.launch(outs, program, **run), 5)
            line += f"; {ms:.3f} ms a launch at {GLOBAL_ROW_LENGTHS[1]} on {card}"
        print(line)
    return errs


def render_sequence(torch, proc, frames):
    """Render ``frames`` on ``proc`` and record every renderer call as
    (program, blocks): 'super' (a superblock), 'fast' (an event-free
    block), 'full' (an eventful block). Returns (audio tensor, sequence)."""
    import knaster_tpu_torch.graph.processor as gp

    seq, real = [], gp.get_super_fn

    def get(cg, k, *a, **kw):
        fn = real(cg, k, *a, **kw)
        if fn is None:
            return None

        def logged(*args):
            seq.append(("super", k))
            return fn(*args)
        return logged

    proc._ensure_compiled()
    cg = proc.compiled
    fast, full = cg.render_fast, cg.render

    def fast_logged(*args):
        seq.append(("fast", 1))
        return fast(*args)

    def full_logged(*args):
        seq.append(("full", 1))
        return full(*args)

    gp.get_super_fn, cg.render_fast, cg.render = get, fast_logged, full_logged
    try:
        audio = proc.render(frames=frames, fetch=False)
    finally:
        gp.get_super_fn, cg.render_fast, cg.render = real, fast, full
    return audio, seq


def phase_float_osc_card_vs_cpu(torch, np, kt, dev, card):
    """``phasor_cascade`` and ``sin_numeric_cascade`` over their first 128
    blocks (one render chunk) on the card and on the CPU: the card's
    (program, length) sequence equals the CPU's (the JAX bounce's: one
    superblock of 128 blocks), its kernel launches once, and the samples
    agree within 1e-6 (the card's sin and torch's CPU sin differ at the
    ulp)."""
    for name, build in float_osc_paths(kt).items():
        got = {}
        for d in (dev, "cpu"):
            g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=BLOCK),
                                            device=d)
            g.edit(lambda gg: build(kt, gg))
            reset_all_counts()
            audio, seq = render_sequence(torch, proc, CHUNK * BLOCK)
            got[str(d)] = (audio.cpu().numpy(), seq, read_all_counts())
        (a, seq_card, counts), (b, seq_cpu, _) = got[str(dev)], got["cpu"]
        expect_counts(counts, {"chain_kernel": 1}, f"{name} first chunk")
        gap = float(np.abs(a - b).max())
        if seq_card != seq_cpu or seq_card != [("super", CHUNK)]:
            fail(f"{name}: the card's partition {seq_card} is not the CPU's {seq_cpu}")
        if gap > 1e-6 or not np.isfinite(a).all():
            fail(f"{name}: card vs CPU over the first {CHUNK} blocks differ by {gap}")
        print(f"slice {name} on {card}: the first {CHUNK} blocks as {seq_card} on the "
              f"card and the CPU, one chain kernel launch; card vs CPU {gap:.3e}")


def fdn_processor(torch, kt, dev):
    """Golden fdn_galactic's processor on ``dev``, the burst fired, the
    seed counter reset first (as tests/golden_configs.py renders it)."""
    kt.reset_randomness_seeds()
    g, proc = kt.AudioProcessor.new(0, 2, kt.AudioProcessorOptions(block_size=BLOCK),
                                    dtype=torch.float32, device=dev)
    g.edit(lambda gg: build_fdn(kt, gg)).trig()
    proc._ensure_compiled()
    return proc


def phase_fdn_galactic(torch, np, kt, dev, card):
    """Golden fdn_galactic (f32, 1 s, B = 64): every block eventful or
    behind a feedback edge, so rendered block by block; no chain forms, so
    the one kernel on its path is Galactic's, once a block. The card's
    render against the port's CPU render over its first FDN_CPU_FRAMES, and
    against the f32 fixture over the whole second (the golden gate, 1e-6 +
    2^-23); realtime x of the whole render and the CUDA kernels per
    rendered second over its first FDN_PROFILE blocks (torch.profiler)."""
    ref, sr = read_fixture("fdn_galactic_f32")
    proc = fdn_processor(torch, kt, dev)
    reset_all_counts()
    t0 = time.perf_counter()
    a = np.asarray(proc.render(frames=FDN_FRAMES))
    card_secs = time.perf_counter() - t0
    expect_counts(read_all_counts(), {"galactic": FDN_FRAMES // BLOCK}, "fdn_galactic")
    b = np.asarray(fdn_processor(torch, kt, "cpu").render(frames=FDN_CPU_FRAMES))
    proc = fdn_processor(torch, kt, dev)
    n_k = count_kernels(torch, lambda: proc.render(frames=FDN_PROFILE * BLOCK, fetch=False))
    gap = float(np.abs(a[:, :FDN_CPU_FRAMES] - b).max())
    err = float(np.abs(a - ref).max())
    if sr != SR or ref.shape != a.shape or not np.isfinite(a).all():
        fail(f"fdn_galactic: fixture {ref.shape} at {sr} Hz against a render {a.shape}")
    if gap > 1e-6 or err > GOLDEN_GATE or np.abs(ref).max() < 0.05:
        fail(f"fdn_galactic: card vs CPU {gap}, card vs the fixture {err} (gate "
             f"{GOLDEN_GATE})")
    lps = None if n_k is None else n_k / (FDN_PROFILE * BLOCK / SR)
    print(f"slice fdn_galactic on {card}: 1 s in {card_secs:.3f} s, realtime x "
          f"{1.0 / card_secs:.4g}, {lps} kernel launches per rendered s; card vs CPU "
          f"{gap:.3e} over the first {FDN_CPU_FRAMES} samples, card vs the f32 fixture "
          f"{err:.3e} (gate {GOLDEN_GATE:.3e}); Galactic's kernel once a block")
    return 1.0 / card_secs, lps


def phase_galactic_chain(torch, np, kt, dev, card):
    """``galactic_chain`` (GALACTIC_FRAMES, B = 64) superblocked (Galactic's cap, 740
    samples, makes loops of 8-block superblocks) and block by block, each on
    the card against the same render on the CPU, within 1e-6 (the card's
    sin in Galactic's vibrato differs from the CPU's at the ulp); the port
    kernels on its path are the pink noise's and Galactic's. Prints realtime
    x of the card's renders."""
    out = {}
    for chunk in (CHUNK, 1):
        renders = {}
        for d in (dev, "cpu"):
            kt.reset_randomness_seeds()
            opts = kt.AudioProcessorOptions(block_size=BLOCK, render_chunk_blocks=chunk)
            g, proc = kt.AudioProcessor.new(0, 2, opts, device=d)
            g.edit(lambda gg: galactic_chain(kt, gg))
            proc._ensure_compiled()
            reset_all_counts()
            t0 = time.perf_counter()
            renders[str(d)] = np.asarray(proc.render(frames=GALACTIC_FRAMES))
            secs = time.perf_counter() - t0
            if d == dev:
                counts = read_all_counts()
                pink, gal = counts.pop("pink_noise"), counts.pop("galactic")
                expect_counts(counts, {}, "galactic_chain")
                if not pink or not gal:
                    fail(f"galactic_chain: the pink noise kernel launched {pink} times, "
                         f"Galactic's {gal}")
                out[chunk] = GALACTIC_FRAMES / SR / secs
        a, b = renders[str(dev)], renders["cpu"]
        gap = float(np.abs(a - b).max())
        if gap > 1e-6 or not np.isfinite(a).all() or np.abs(a).max() < 1e-3:
            fail(f"galactic_chain chunk={chunk}: card vs CPU differ by {gap}")
        print(f"slice galactic_chain ({'superblocks' if chunk > 1 else 'per block'}) on "
              f"{card}: realtime x {out[chunk]:.4g}; card vs CPU {gap:.3e}; {pink} pink_noise "
              f"and {gal} galactic launches")
    return out


def phase_noise_delay_slices(torch, kt, dev, card):
    """The noise chain, the echo chain and the SampleDelay cascade through
    ``chain_slice``, the first two against the scan executor. Returns
    {path: chain kernel launches}."""
    paths = noise_delay_paths(kt)
    return {name: chain_slice(torch, kt, dev, card, name, paths[name],
                              against_scan=name != "sample_delay_cascade")
            for name in ("noise_chain", "echo_chain", "sample_delay_cascade")}


def param_sweep(kt, g):
    """tests/golden_configs.py:145-169 (config 4): SinNumeric with sets at
    exact frames and a linear smoothing ramp, plus a Phasor LFO driving a
    SinWt's freq through a param edge; 0.3 s."""
    hs = {}

    def build(gg):
        a = gg.push(kt.SinNumeric(220.0))
        lfo = gg.push(kt.Phasor(3.0))
        b = gg.push(kt.SinWt(440.0))
        mod = (lfo * 200.0) + 330.0
        gg.connect_param(gg.handle(mod.channels[0][1]), 0, b, "freq")
        ((a + b) * 0.2).to_graph_out()
        hs["a"] = a

    g.edit(build)
    freq = hs["a"].param("freq")
    freq.set_at(330.0, kt.Seconds.from_samples(1000, SR))
    freq.set_at(550.0, kt.Seconds.from_samples(2500, SR))
    freq.smooth(kt.Smoothing.linear(0.05))
    freq.set_at(110.0, kt.Seconds.from_samples(7000, SR))


PARAM_SWEEP_FRAMES = 14400


def phase_param_sweep(torch, np, kt, dev, card):
    """Golden param_sweep on the card at f32 and f64 against the port's CPU
    render: within 1e-6, since both take one association and one
    partition. Its nodes form no chain, so no kernel runs."""
    for dtype in (torch.float32, torch.float64):
        renders = {}
        for d in (dev, "cpu"):
            g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=BLOCK),
                                            dtype=dtype, device=d)
            param_sweep(kt, g)
            reset_all_counts()
            t0 = time.perf_counter()
            renders[str(d)] = np.asarray(proc.render(frames=PARAM_SWEEP_FRAMES))
            secs = time.perf_counter() - t0
            if d == dev:
                expect_counts(read_all_counts(), {}, "param_sweep")
                card_secs = secs
        gap = float(np.abs(renders[str(dev)] - renders["cpu"]).max())
        peak = float(np.abs(renders["cpu"]).max())
        if gap > 1e-6 or not np.isfinite(renders[str(dev)]).all() or peak < 0.3:
            fail(f"param_sweep {dtype}: card vs CPU render differ by {gap} (peak {peak})")
        print(f"slice param_sweep {str(dtype)[6:]}: 0.3 s on the card ({card_secs:.3f} s, "
              f"realtime x {0.3 / card_secs:.4g}) equals the CPU render to {gap:.3e} "
              f"(peak {peak:.4g}); no kernel on its path")


def subtractive_voice(kt, g):
    """tests/golden_configs.py:57-82 (config 2): a PolyBlep saw into an SVF
    lowpass gated by EnvAsr, with sample-accurate cutoff sets, a smoothing
    ramp, a restart and a release at frame 12,000."""
    hs = {}

    def build(gg):
        saw = gg.push(kt.PolyBlep(kt.Waveform.Sawtooth, 110.0))
        svf = gg.push(kt.SvfFilter(kt.SvfFilterType.Low, 900.0, q=2.5))
        env = gg.push(kt.EnvAsr(attack_time=0.01, release_time=0.08))
        saw.to(svf)
        (svf * env * 0.5).to_graph_out()
        hs["svf"], hs["env"] = svf, env

    g.edit(build)
    hs["env"].param("t_restart").trig()
    cutoff = hs["svf"].param("cutoff_freq")
    cutoff.set_at(500.0, kt.Seconds.from_samples(4000, SR))
    cutoff.smooth(kt.Smoothing.linear(0.1))
    cutoff.set_at(4500.0, kt.Seconds.from_samples(4801, SR))
    hs["env"].param("t_release").trig_at(kt.Seconds.from_samples(12000, SR))


def kernel_vs_scan(torch, kt, dev, build, n_blocks, skip):
    """The graph's blocks ``skip`` to ``skip + n_blocks`` through the scan
    executor on the card (``_MODE = "0"``); returns (audio tensor, seconds
    for them)."""
    import knaster_tpu_torch.graph.chain_kernel as gck

    gck._MODE = "0"
    try:
        g, scan = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=BLOCK),
                                        device=dev)
        g.edit(lambda gg: build(kt, gg))
        restart_envelopes(g)
        scan.render(frames=skip * BLOCK, fetch=False)
        t0 = time.perf_counter()
        ref = scan.render(frames=n_blocks * BLOCK, fetch=False)
        torch.cuda.synchronize()
        return ref, time.perf_counter() - t0
    finally:
        gck._MODE = None


def phase_subtractive_slices(torch, np, kt, dev, card):
    """The subtractive slice through AudioProcessor.render on the card.
    Returns {path: chain kernel launches}."""
    launches = {}
    # subtractive_voice: the golden config, card against the CPU render;
    # three nodes are no chain, so no kernel runs
    renders = {}
    for d in (dev, "cpu"):
        g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=BLOCK),
                                        dtype=torch.float32, device=d)
        subtractive_voice(kt, g)
        reset_all_counts()
        t0 = time.perf_counter()
        renders[str(d)] = np.asarray(proc.render(frames=19200))
        secs = time.perf_counter() - t0
        if d == dev:
            expect_ugen_kernels(read_all_counts(), ("svf_filter", "env_asr"),
                                "subtractive_voice")
            card_secs = secs
    gap = float(np.abs(renders[str(dev)] - renders["cpu"]).max())
    peak = float(np.abs(renders["cpu"]).max())
    if gap > 1e-6 or not np.isfinite(renders[str(dev)]).all() or peak < 0.5:
        fail(f"subtractive_voice: card vs CPU render differ by {gap} (peak {peak})")
    print(f"slice subtractive_voice: 0.4 s on the card ({card_secs:.3f} s, realtime x "
          f"{0.4 / card_secs:.4g}) equals the CPU render to {gap:.3e} (peak {peak:.4g}); "
          "no kernel on its path")

    for name in ("polyblep_cascade", "graphic_eq_31"):
        launches[name] = chain_slice(torch, kt, dev, card, name, chain_paths(kt)[name])

    # the test shapes at B = 16: restart, then release; kernel path against
    # the scan executor, and the FREE_PARENT chain zeroes the output from
    # its done frame
    for name in ("onepole_chain", "env_asr_chain", "env_asr_free_parent", "env_ar_chain",
                 "pan2_chain"):
        build = chain_paths(kt)[name]
        runs = {}
        for mode in (None, "0"):
            import knaster_tpu_torch.graph.chain_kernel as gck

            gck._MODE = mode
            try:
                g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=16),
                                                device=dev)
                g.edit(lambda gg: build(kt, gg))
                restart_envelopes(g)
                reset_all_counts()
                a = proc.render(frames=64)
                for nid, e in list(g.nodes.items()):
                    if "t_release" in e.ugen.param_names():
                        g.handle(nid).param("t_release").trig()
                b = proc.render(frames=320)
                runs[mode] = (np.concatenate([a, b], axis=1), read_all_counts(), proc)
            finally:
                gck._MODE = None
        (audio, counts, proc), (ref, _, _) = runs[None], runs["0"]
        if counts["chain_kernel"] < 1 or not np.array_equal(audio, ref):
            fail(f"{name}: kernel path ({counts['chain_kernel']} launches) differs from "
                 f"the scan executor by {float(np.abs(audio - ref).max())}")
        note = ""
        if name == "env_asr_free_parent":
            nz = np.flatnonzero(np.abs(audio[0]) > 0)
            if not nz.size or nz[-1] >= audio.shape[1] - 1 or not proc.freed:
                fail(f"{name}: the output was not zeroed from the done frame on")
            note = f"; the output is zero from frame {nz[-1] + 1} on, the graph freed"
        elif name.startswith("env"):
            if np.abs(audio[:, -16:]).max() != 0.0:
                fail(f"{name}: the release did not end")
        print(f"slice {name} (B=16): {counts['chain_kernel']} chain kernel launches, "
              f"384 samples equal to the scan executor's{note}")
    return launches


def chain_slice(torch, kt, dev, card, name, build, against_scan=True):
    """One chain path through AudioProcessor.render on the card (B = 64, 2 s
    after the blocks that carry the graph's initial param sets, then again):
    the chain kernel once per event-free superblock, and (``against_scan``)
    the first 64 blocks bit-equal to the scan executor's. Returns the chain
    kernel's launches."""
    n_blocks = int(GRAPH_SECONDS * SR) // BLOCK
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=BLOCK),
                                    device=dev)
    g.edit(lambda gg: build(kt, gg))
    # the blocks that carry the initial param sets (eventful: the scan
    # executor), then every block is event-free
    proc.render(frames=WARM_BLOCKS * BLOCK, fetch=False)
    reset_all_counts()
    audio, secs = render_timed(torch, proc, GRAPH_SECONDS)
    counts = read_all_counts()
    expect_counts(counts, {"chain_kernel": event_free_pieces(proc, n_blocks)}, name)
    if [k for k, _ in proc.compiled.plan].count("chain") != 1:
        fail(f"{name}: the graph did not collapse into one chain")
    peak = float(audio.abs().max())
    if not bool(torch.isfinite(audio).all()) or peak == 0.0:
        fail(f"{name}: output not finite or silent")
    _, secs2 = render_timed(torch, proc, GRAPH_SECONDS)
    note = ""
    if against_scan:
        ref, t_scan = kernel_vs_scan(torch, kt, dev, build, 64, WARM_BLOCKS)
        head = audio[:, :64 * BLOCK].contiguous()
        if not torch.equal(bits(head), bits(ref)):
            fail(f"{name}: the kernel path differs from the scan executor by "
                 f"{float((head - ref).abs().max())}")
        note = f"; its first 64 blocks bit-equal to the scan executor's ({t_scan:.2f} s)"
    print(f"slice {name}: {n_blocks} blocks of {BLOCK} in {secs:.4f} s, realtime x "
          f"{GRAPH_SECONDS / secs:.4g} (again: {GRAPH_SECONDS / secs2:.4g}) on {card}; "
          f"chain kernel launches {counts['chain_kernel']} (one per superblock); "
          f"peak {peak:.4g}{note}")
    return counts["chain_kernel"]


def render_timed(torch, proc, seconds):
    """Render on the card; returns (audio tensor, wall seconds)."""
    proc._ensure_compiled()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio = proc.render(seconds=seconds, fetch=False)
    torch.cuda.synchronize()
    return audio, time.perf_counter() - t0


def zero_crossing_hz(np, x, sr):
    return float(np.sum((x[:-1] < 0) & (x[1:] >= 0))) * sr / len(x)


def event_free_pieces(proc, n_blocks):
    """The renderer calls (each one launch of a kernel on the path) with
    which ``AudioProcessor.render`` covers ``n_blocks`` event-free blocks
    from a chunk boundary: per chunk, lengths halving from the chunk, each
    one superblock within the graph's cap, a loop of capped superblocks
    from MIN_SCAN blocks up, else single blocks (graph/processor.py)."""
    from knaster_tpu_torch.graph.compile import superblock_eligible
    from knaster_tpu_torch.graph.processor import MIN_SCAN

    cg, chunk = proc.compiled, proc.options.render_chunk_blocks
    cap = (int(min(cg.superblock_max, 2**31) // cg.ctx.block_size)
           if superblock_eligible(cg) else 1)
    calls = 0
    while n_blocks:
        run = min(chunk, n_blocks)
        n_blocks -= run
        while run:
            sub = chunk
            while sub > run:
                sub //= 2
            if 2 <= sub <= cap:
                calls += 1
            elif sub >= MIN_SCAN:
                k = 1
                while 2 * k <= min(sub, cap) and sub % (2 * k) == 0:
                    k *= 2
                calls += sub // k if k >= 2 else sub
            else:
                sub = 1
                calls += 1
            run -= sub
    return calls


def expect_counts(counts, want, where):
    """Every kernel's launch count is zero but those in ``want``."""
    bad = {k: n for k, n in counts.items() if n != want.get(k, 0)}
    if bad:
        fail(f"{where}: kernel launches {bad}, expected {want or 'none'}")


def phase_graph_slices(torch, np, kt, dev, card):
    """The graph slices through AudioProcessor.render on the card. Returns
    {kernel: launches} of the two cascade slices."""
    import knaster_tpu_torch.graph.chain_kernel as gck

    launches = {}
    # readme_sine: tests/golden_configs.py:41-54, against the CPU render
    renders = {}
    for d in (dev, "cpu"):
        g, proc = kt.AudioProcessor.new(0, 2, kt.AudioProcessorOptions(block_size=BLOCK),
                                        dtype=torch.float32, device=d)
        readme_sine(kt, g)
        reset_all_counts()
        renders[str(d)] = np.asarray(proc.render(seconds=0.5))
        if d == dev:
            expect_counts(read_all_counts(), {}, "readme_sine")
    gap = float(np.abs(renders[str(dev)] - renders["cpu"]).max())
    peak = float(np.abs(renders["cpu"]).max())
    if gap > 1e-6 or not 0.19 < peak <= 0.2:
        fail(f"readme_sine: card vs CPU render differ by {gap} (peak {peak})")
    print(f"slice readme_sine: 0.5 s on the card equals the CPU render to {gap:.3e} "
          f"(peak {peak:.4g}); no kernel on its path")

    # the README example, 2 s: smoothing and a set at 1.0 s
    graph, proc = kt.knaster(outputs=2, device=dev)
    readme_example(kt, graph)
    audio = proc.render(seconds=2.0)
    halves = (audio[0, :SR], audio[0, SR:])
    desc = ", ".join(f"peak {np.abs(h).max():.4g} at {zero_crossing_hz(np, h, SR):.1f} Hz"
                     for h in halves)
    if not (abs(zero_crossing_hz(np, halves[0], SR) - 440) <= 2
            and abs(zero_crossing_hz(np, halves[1], SR) - 880) <= 2):
        fail(f"README example: {desc}")
    print(f"slice README example: 2 s, before the set {desc.split(', ')[0]}, after it "
          f"{desc.split(', ')[1]}")

    # fm_cascade: 256 SinWt stages as graph nodes, B=64, 2 s
    n_blocks = int(GRAPH_SECONDS * SR) // BLOCK
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=BLOCK),
                                    device=dev)
    g.edit(lambda gg: build_cascade(kt, gg, CASCADE))
    reset_all_counts()
    audio, secs = render_timed(torch, proc, GRAPH_SECONDS)
    counts = read_all_counts()
    expect_counts(counts, {"chain_kernel": event_free_pieces(proc, n_blocks)}, "fm_cascade")
    launches["chain_kernel"] = counts["chain_kernel"]
    if [k for k, _ in proc.compiled.plan].count("chain") != 1:
        fail("fm_cascade: the cascade did not collapse into one chain")
    if not bool(torch.isfinite(audio).all()) or float(audio.abs().max()) == 0.0:
        fail("fm_cascade: output not finite or silent")
    _, secs2 = render_timed(torch, proc, GRAPH_SECONDS)
    rt = [GRAPH_SECONDS / t for t in (secs, secs2)]
    # the scan executor over the first 64 blocks, against the kernel path
    gck._MODE = "0"
    try:
        g2, scan = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=BLOCK),
                                         device=dev)
        g2.edit(lambda gg: build_cascade(kt, gg, CASCADE))
        t0 = time.perf_counter()
        ref = scan.render(frames=64 * BLOCK, fetch=False)
        torch.cuda.synchronize()
        t_scan = time.perf_counter() - t0
    finally:
        gck._MODE = None
    err = float((audio[:, :64 * BLOCK] - ref).abs().max())
    if not torch.equal(bits(audio[:, :64 * BLOCK].contiguous()), bits(ref)):
        fail(f"fm_cascade: the kernel path differs from the scan executor by {err}")
    print(f"slice fm_cascade: {CASCADE} stages as graph nodes, {n_blocks} blocks of "
          f"{BLOCK} in {secs:.4f} s, realtime x {rt[0]:.4g} (again: {rt[1]:.4g}) on "
          f"{card}; chain kernel launches {counts['chain_kernel']}; the first 64 "
          f"blocks bit-equal to the scan executor ({t_scan:.2f} s for them, realtime x "
          f"{64 * BLOCK / SR / t_scan:.3g})")

    # fm_cascade_model: FMCascade(256), B=64, 2 s
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=BLOCK),
                                    device=dev)
    g.edit(lambda gg: gg.push(kt.FMCascade(CASCADE)).to_graph_out())
    reset_all_counts()
    audio, secs = render_timed(torch, proc, GRAPH_SECONDS)
    counts = read_all_counts()
    expect_counts(counts, {"fm_cascade": event_free_pieces(proc, n_blocks)},
                  "fm_cascade_model")
    launches["fm_cascade"] = counts["fm_cascade"]
    peak = float(audio.abs().max())
    if not bool(torch.isfinite(audio).all()) or not 0.05 < peak <= float(np.float32(0.1)):
        fail(f"fm_cascade_model: output not finite or peak {peak} outside (0.05, amp]")
    _, secs2 = render_timed(torch, proc, GRAPH_SECONDS)
    rt_model = [GRAPH_SECONDS / t for t in (secs, secs2)]
    print(f"slice fm_cascade_model: FMCascade({CASCADE}), {n_blocks} blocks in "
          f"{secs:.4f} s, realtime x {rt_model[0]:.4g} (again: {rt_model[1]:.4g}) on "
          f"{card}; fm_cascade launches {counts['fm_cascade']}. A/B: graph nodes on the "
          f"chain kernel {rt[0]:.4g}x vs the fused UGen {rt_model[0]:.4g}x realtime")

    # sines_const: 256 independent SinWt * 0.001 (benchmarks/suite.py:328-345)
    for bs in (16, 64):
        g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=bs),
                                        device=dev)
        g.edit(lambda gg: sines_const(kt, gg))
        reset_all_counts()
        audio, secs = render_timed(torch, proc, GRAPH_SECONDS)
        expect_counts(read_all_counts(), {}, f"sines_const B={bs}")
        plan = [k for k, _ in proc.compiled.plan]
        if plan.count("batch") < 3 or not bool(torch.isfinite(audio).all()) or float(
                audio.abs().max()) == 0.0:
            fail(f"sines_const B={bs}: plan {plan} or output not finite or silent")
        _, secs2 = render_timed(torch, proc, GRAPH_SECONDS)
        print(f"slice sines_const: 256 sines, B={bs}, auto-batched {plan}, no kernel; "
              f"realtime x {GRAPH_SECONDS / secs:.4g} (again: {GRAPH_SECONDS / secs2:.4g}) "
              f"on {card}")
    return launches


def sines_const(kt, gg):
    """benchmarks/suite.py:328-345: 256 independent SinWt * 0.001."""
    import numpy as np

    rng = np.random.default_rng(1)
    for _ in range(256):
        (gg.push(kt.SinWt(float(rng.uniform(100, 1000)))) * 0.001).to_graph_out()


def readme_example(kt, g):
    """README.md's example: a sine times a constant, amp smoothing, a set at
    1.0 s."""
    def build(gg):
        sine = gg.push(kt.SinWt(440.0))
        amp = gg.push(kt.Constant(0.2))
        (sine * amp).out([0, 0]).to_graph_out()
        return sine.param("freq"), amp.param("value")

    freq, amp = g.edit(build)
    amp.smooth(kt.Smoothing.linear(0.1))
    freq.set_at(880.0, kt.Seconds.from_secs_f64(1.0))


def readme_sine(kt, g):
    """tests/golden_configs.py:41-54 (config 1)."""
    def build(gg):
        sine = gg.push(kt.SinWt(440.0))
        amp = gg.push(kt.Constant(0.2))
        (sine * amp).out([0, 0]).to_graph_out()

    g.edit(build)


def test_chain(name):
    """The B = 16 test-shape chain ``name``: its envelopes restarted now and
    released at frame 64, as the subtractive slices phase drives it."""
    def setup(kt, g):
        build = chain_paths(kt)[name]
        g.edit(lambda gg: build(kt, gg))
        restart_envelopes(g)
        for nid, e in list(g.nodes.items()):
            if "t_release" in e.ugen.param_names():
                g.handle(nid).param("t_release").trig_at(kt.Seconds.from_samples(64, SR))
    return setup


def nodes(build):
    """A slice setup from a graph builder over ``gg``."""
    return lambda kt, g: g.edit(lambda gg: build(kt, gg))


# How a slice's superblocked render compares with its per-block one. u32
# phases (SinWt, PolyBlep, the FM cascade kernel) and stateless bodies do
# not depend on the partition: bit-equal. A float scan over a superblock
# associates otherwise than over single blocks: the SVF's and the
# one-poles' affine scans and the envelopes' rate sums, within 1e-6 (CPU
# renders of these graphs: 4.8e-7 at most); param_sweep's SinNumeric
# holds an unwrapped f32 phase over up to 64 blocks (up to 47 cycles,
# an ulp of 3.8e-6 there) where the per-block render wraps it every block,
# and its LFO's drift moves SinWt's table index: within 1e-4 (8.55e-5 on
# the CPU); the two float-oscillator cascades feed each stage's error into
# the next one's frequency, so only their first 64 blocks are held, the
# Phasor's by the distance on its 0.2-period wrap: 1e-6 and 1e-5 (3.5e-7
# and 1.3e-6 on the CPU). sines_const's 256-source mix is one torch.sum,
# whose order torch picks by the row length: within 1e-6 (3.0e-8 on the
# CPU).
EXACT = ("exact",)


# the partition phase's render of the slices that render GRAPH_SECONDS
# elsewhere: one longest superblock, CHUNK blocks at B = 64 (0.256 s until
# the examples came, 1 s until the buffer phase came, 0.5 s until the
# user's side came), to keep the whole run within its time limit as the
# phases grow
PARTITION_SECONDS = CHUNK * BLOCK / SR


# the partition slices whose SvfFilters and EnvAsrs run their own process on
# the card, and their kernels: the subtractive voice's, and the chains' in
# their eventful blocks (the scan executor)
UGEN_PARTITIONS = {"subtractive_voice": ("svf_filter", "env_asr"),
                   "graphic_eq_31": ("svf_filter",), "env_asr_chain": ("env_asr",),
                   "env_asr_free_parent": ("env_asr",)}


def partition_slices():
    """name -> (block size, outputs, frames, setup(kt, g), comparison, the
    kernel its chain or UGen launches or None, whether it renders without
    events)."""
    s2 = int(PARTITION_SECONDS * SR)
    ck = "chain_kernel"
    return {
        "readme_sine": (BLOCK, 2, SR // 2, readme_sine, EXACT, None, True),
        "README example": (BLOCK, 2, s2, readme_example, EXACT, None, False),
        "fm_cascade": (BLOCK, 1, s2, nodes(lambda kt, gg: build_cascade(kt, gg, CASCADE)),
                       EXACT, ck, True),
        "fm_cascade_model": (BLOCK, 1, s2, nodes(
            lambda kt, gg: gg.push(kt.FMCascade(CASCADE)).to_graph_out()), EXACT,
            "fm_cascade", True),
        "sines_const B=16": (16, 1, s2, nodes(sines_const), ("tol", 1e-6), None, True),
        "sines_const B=64": (BLOCK, 1, s2, nodes(sines_const), ("tol", 1e-6), None, True),
        "subtractive_voice": (BLOCK, 1, 19200, subtractive_voice, ("tol", 1e-6), None,
                              False),
        "polyblep_cascade": (BLOCK, 1, s2, nodes(polyblep_cascade), EXACT, ck, False),
        "graphic_eq_31": (BLOCK, 1, s2, nodes(graphic_eq_31), ("tol", 1e-6), ck, False),
        "param_sweep": (BLOCK, 1, PARAM_SWEEP_FRAMES, param_sweep, ("tol", 1e-4), None,
                        False),
        "phasor_cascade": (BLOCK, 1, s2, nodes(phasor_cascade), ("head", 1e-6, 0.2), ck,
                           True),
        "sin_numeric_cascade": (BLOCK, 1, s2, nodes(sin_numeric_cascade),
                                ("head", 1e-5, None), ck, True),
        "onepole_chain": (16, 1, 384, test_chain("onepole_chain"), ("tol", 1e-6), ck,
                          False),
        "env_asr_chain": (16, 1, 384, test_chain("env_asr_chain"), ("tol", 1e-6), ck,
                          False),
        "env_asr_free_parent": (16, 1, 384, test_chain("env_asr_free_parent"),
                                ("tol", 1e-6), ck, False),
        "env_ar_chain": (16, 1, 384, test_chain("env_ar_chain"), ("tol", 1e-6), ck, False),
        "pan2_chain": (16, 1, 384, test_chain("pan2_chain"), EXACT, ck, False),
    }


def count_kernels(torch, run):
    """The CUDA kernels torch.profiler records over ``run()`` (None when it
    records no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)
    return n or None


# the window whose launches the partition phase counts: one render chunk
# superblocked (an eventful first block dominates it where the schedule
# has one: the polyblep cascade's ~49,500 launches)
PROFILE_BLOCKS = CHUNK
# slices whose superblocked launches are not counted, to keep the run in
# its time limit: the profiler took 23.96 s (the polyblep cascade) and
# 19.80 s (env_asr_chain) of it on an H100 (PERF.md §6)
UNCOUNTED_PARTITIONS = ("polyblep_cascade", "env_asr_chain")


def phase_partitions(torch, np, kt, dev, card):
    """Every graph slice rendered on the card twice from the same schedule:
    with superblocks (the default) and block by block
    (``render_chunk_blocks=1``). Each pair compared as ``partition_slices``
    says; each render's realtime x (unprofiled) and the superblocked one's
    kernel launches per rendered second (the profiler's count over up to
    PROFILE_BLOCKS blocks of a third render) printed beside the card.
    Returns {slice: (realtime x, launches/s) superblocked and per block
    (None: not counted; never for UNCOUNTED_PARTITIONS), the port's own
    kernel launches of the superblocked render}."""
    out = {}
    for name, (bs, outs, frames, setup, how, kernel, free) in partition_slices().items():
        t_slice = time.perf_counter()
        res = {}
        for chunk in (CHUNK, 1):
            opts = kt.AudioProcessorOptions(block_size=bs, render_chunk_blocks=chunk)
            runs = []
            # the timed render, then the profiled one superblocked; block by
            # block nothing is counted (the profiler took up to 28 s a slice
            # to collect those launches, to keep the run in its time limit)
            for _ in range(2 if chunk == CHUNK else 1):
                g, proc = kt.AudioProcessor.new(0, outs, opts, device=dev)
                setup(kt, g)
                proc._ensure_compiled()
                runs.append(proc)
            reset_all_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            audio = runs[0].render(frames=frames, fetch=False)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = {k: n for k, n in read_all_counts().items() if n}
            if chunk == CHUNK:  # the main path's run: its kernel, and no other
                want = {} if kernel is None else {
                    kernel: event_free_pieces(runs[0], frames // bs) if free
                    else max(1, counts.get(kernel, 0))}
                # the kernels of the UGens that run their own process
                # (outside a chain, or in a chain's eventful blocks)
                for k in UGEN_PARTITIONS.get(name, ()):
                    want[k] = max(1, counts.get(k, 0))
                expect_counts(counts, want, f"partition {name}")
            n_prof = min(frames, PROFILE_BLOCKS * bs)
            n_k = (count_kernels(torch, lambda: runs[1].render(frames=n_prof, fetch=False))
                   if chunk == CHUNK and name not in UNCOUNTED_PARTITIONS else None)
            res[chunk] = (audio, frames / SR / secs,
                          None if n_k is None else n_k / (n_prof / SR), counts)
        (a, rt_sb, lps_sb, counts), (b, rt_pb, lps_pb, _) = res[CHUNK], res[1]
        if not bool(torch.isfinite(a).all()) or float(a.abs().max()) == 0.0:
            fail(f"partition {name}: the superblocked render is not finite or silent")
        if how[0] == "exact":
            diff = float((a - b).abs().max())
            ok = torch.equal(bits(a), bits(b))
            held = "bit-equal"
        elif how[0] == "tol":
            diff = float((a - b).abs().max())
            ok, held = diff <= how[1], f"within {how[1]:g}"
        else:
            d = (a - b)[:, :64 * bs].abs()
            if how[2] is not None:
                d = torch.minimum(d, how[2] - d)
            diff = float(d.max())
            ok, held = diff <= how[1], f"within {how[1]:g} over the first 64 blocks"
        if not ok:
            fail(f"partition {name}: superblocked and per-block renders differ by {diff} "
                 f"(held {held})")
        full = float((a - b).abs().max())
        print(f"partition {name} (B={bs}, {frames / SR:g} s) on {card}: superblocks "
              f"realtime x {rt_sb:.4g}, {lps_sb or 'not counted'} launches per rendered s, kernels {counts}; "
              f"per block realtime x {rt_pb:.4g}; "
              f"{held} ({diff:.3e}; whole render {full:.3e}) "
              f"({time.perf_counter() - t_slice:.1f} s)")
        out[name] = (rt_sb, lps_sb, rt_pb, lps_pb, counts)
    return out


def device_ms(torch, fn, name, n=50):
    """The profiler's device time per call of the kernels whose name holds
    ``name``, over ``n`` calls (None when it records none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and name in e.key)
    return us / n / 1000.0 if us else None


# The parent design's chain kernel (one CTA interpreting the program from
# device memory, rows in shared memory or the global workspace): CUDA events
# over back-to-back launch() calls of the parent commit's tree on an NVIDIA
# H100 80GB HBM3 at 700.00 W, {path: {B: ms}} (PERF.md §6; a comparison of
# the two trees in one call is tools/time_chain_kernel.py's)
PARENT_CHAIN_MS = {
    "fm_cascade": {16: 0.6992, 64: 0.6818, 1024: 1.0189, 8192: 5.0978},
    "polyblep_cascade": {16: 0.8814, 64: 0.8472, 1024: 1.2922, 8192: 6.0843},
    "sin_numeric_cascade": {16: 0.8286, 64: 0.9218, 1024: 1.7715, 8192: 7.2922},
    "graphic_eq_31": {16: 0.1098, 64: 0.1122, 1024: 0.2954, 8192: 2.9573},
    "sample_delay_cascade": {16: 1.1738, 64: 0.7513, 1024: 0.622, 8192: 1.5952},
    "phasor_cascade": {16: 0.044, 64: 0.0436, 1024: 0.0758, 8192: 0.2625},
    "noise_chain": {16: 0.0423, 64: 0.0357, 1024: 0.0811, 8192: 0.5397},
    "echo_chain": {16: 0.0303, 64: 0.043, 1024: 0.0427, 8192: 0.1101},
    "env_ar_chain": {16: 0.0309, 64: 0.0318, 1024: 0.0559, 8192: 0.2458},
    "onepole_chain": {16: 0.0414, 64: 0.0473, 1024: 0.0773, 8192: 0.3963},
}


def against_parent(path, B, ms):
    """`` (x.xx the parent's y ms)`` where the parent was timed at B."""
    ref = PARENT_CHAIN_MS.get(path, {}).get(B)
    return f" ({ms / ref:.3f}x the parent's {ref:.4f} ms)" if ref else ""


def phase_stage_timings(torch, np, kt, dev, card):
    """Kernel ms (CUDA events over back-to-back launches into preallocated
    outputs) of the two stage-loop kernels at B in STAGE_BLOCKS and at the
    longest superblock of a B = 64 render (CHUNK * BLOCK), there with the
    profiler's device ms, the plain ms and the bound; the 256-stage graph
    cascade gives the chain kernel K = 255 (its first sine heads the
    chain). Prints the chain kernel's time against the parent's (PARENT_CHAIN_MS). Returns
    {kernel: (ms, plain_ms, bound_ms, bound_by)} at the superblock length,
    the length the slices' renders launch them at."""
    f2pi, scale = stage_consts(np)
    kck, kfc = stage_module("chain_kernel"), stage_module("fm_cascade")
    out = {}
    sb = CHUNK * BLOCK
    for B in STAGE_BLOCKS + (sb,):
        params = torch.tensor(FM_PARAM_SETS[0][1], dtype=torch.float32, device=dev)
        ph = u32_near_top(torch, np, CASCADE, 0, dev)
        buf = torch.empty((B,), dtype=torch.float32, device=dev)
        ops = dict(params=params, phases=ph, block_size=B, f2pi=f2pi, scale=scale)
        fm_plan = kfc.launch(buf, **ops)
        fm_ms = time_call(torch, lambda: kfc.launch(buf, **ops), 200)

        g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=B),
                                        device=dev)
        g.edit(lambda gg: build_cascade(kt, gg, CASCADE))
        program, cops = capture_chain(torch, proc)
        outs = kck.empty_outputs(program, dev, cops["K"], B)
        ch_ms = time_call(torch, lambda: kck.launch(outs, program, **cops), 200)
        line = (f"timing B={B} on {card}: fm_cascade N={CASCADE} kernel {fm_ms:.4f} ms "
                f"(cluster {fm_plan.cluster} of {fm_plan.chunk} samples), "
                f"chain_kernel K={cops['K']} p={program.period} kernel {ch_ms:.4f} ms")
        line += against_parent("fm_cascade", B, ch_ms)
        if B == sb:
            # the same launch with its rows in the global workspace
            gl_ms = time_call(
                torch, lambda: kck.launch(outs, program, global_rows=True, **cops), 50)
            line += f", with global rows {gl_ms:.4f} ms"
            fm_dev = device_ms(torch, lambda: kfc.launch(buf, **ops), "fm_cascade")
            ch_dev = device_ms(torch, lambda: kck.launch(outs, program, **cops),
                               "chain_kernel")
            fm_plain = time_call(
                torch, lambda: kfc.fm_cascade_plain(**dict(ops, phases=ph.clone())), 3)
            ch_plain = time_call(torch, lambda: kck.chain_kernel_plain(program, **cops), 3)
            fm_bound = bound(tensor_bytes(params, ph, ph, buf),
                             OPS_PER_SAMPLE["fm_cascade"] * CASCADE * B)
            out = {"fm_cascade": (fm_ms, fm_plain) + fm_bound,
                   "chain_kernel": (ch_ms, ch_plain) + chain_bound(program, cops)}
            line += (f"; profiler device {fm_dev} and {ch_dev} ms; plain {fm_plain:.3f} "
                     f"and {ch_plain:.3f} ms; bound {fm_bound[0]:.5f} ms ({fm_bound[1]}) "
                     f"and {out['chain_kernel'][2]:.5f} ms ({out['chain_kernel'][3]})")
        print(line)
    return out


# f32 operations per sample of each chain-kernel body, counted from
# csrc/chain_kernel.cu as OPS_PER_SAMPLE is (a lower bound); the scan
# bodies add their log2(B) Hillis-Steele steps; SinNumeric and Phasor count
# the increment's multiply, ~10 adds of the base-16 scan (8.5 in-row adds
# on average, the row total, the rows-before add), the phase add and sin's
# add, multiply and call, or floor and subtract; WhiteNoise two Threefry
# evaluations (2 + 20 x 5 + 5 x 3 integer operations each) and 7 more,
# counted at the FP32 rate (the card's integer lanes are no faster, so the
# bound stays a lower bound); SampleDelay the delay's multiply, clamp,
# convert and index arithmetic per sample, its ring copy not counted
def body_ops(name, B, channels):
    steps = max(1, math.ceil(math.log2(B)))
    return {"constant": 0, "math": channels, "math1": channels, "sinwt": 5,
            "polyblep": 24, "svf": 57 + 18 * steps, "onepole_lpf": 11 + 3 * steps,
            "onepole_hpf": 12 + 3 * steps, "env_asr": 16 + 2 * steps,
            "env_ar": 24 + 2 * steps, "pan2": 7, "sin_numeric": 15, "phasor": 14,
            "white_noise": 241, "sample_delay": 8}[name]


def chain_bound(program, ops):
    """(bound_ms, bound_by) of one chain kernel launch on ``ops``."""
    kck = stage_module("chain_kernel")
    K, B = ops["K"], ops["block_size"]
    n_ops = K * B * sum(body_ops(r[0].name, B, len(r[4])) for r in program.records())
    outs = kck.empty_outputs(program, ops["state"].device, K, B)
    return bound(tensor_bytes(ops, outs) + 4 * len(program.words), n_ops)


def phase_chain_path_timings(torch, kt, dev, card, paths):
    """The chain kernel's ms per launch on the chain paths ``paths`` ({name:
    builder}) at B in STAGE_BLOCKS and at the longest superblock their
    renders take (CUDA events over back-to-back launches into preallocated
    outputs), there with the profiler's device time, the plain version's ms
    and the bound. Returns {path: (ms, plain_ms, bound_ms, bound_by)} at the
    superblock length."""
    kck = stage_module("chain_kernel")
    out = {}
    for name, build in paths.items():
        line = []
        sb = superblock_len(kt, dev, build)[0]
        for B in STAGE_BLOCKS + (sb,):
            g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=B),
                                            device=dev)
            g.edit(lambda gg: build(kt, gg))
            program, cops = capture_chain(torch, proc)
            outs = kck.empty_outputs(program, dev, cops["K"], B)
            plan = kck.launch(outs, program, **cops)
            ms = time_call(torch, lambda: kck.launch(outs, program, **cops), 200)
            b_ms, b_by = chain_bound(program, cops)
            line.append(f"B={B} {plan.layout} {plan.cluster} {ms:.4f} ms"
                        + against_parent(name, B, ms) + f" (bound {b_ms:.5f} ms, {b_by})")
            if B == sb:
                dev_ms = device_ms(torch, lambda: kck.launch(outs, program, **cops),
                                   "chain_kernel")
                plain_ms = time_call(torch, lambda: kck.chain_kernel_plain(program, **cops), 3)
                out[name] = (ms, plain_ms, b_ms, b_by)
                line.append(f"profiler device {dev_ms} ms, plain {plain_ms:.3f} ms")
        print(f"timing chain_kernel {name} K={cops['K']} p={program.period} on {card}: "
              + "; ".join(line))
    return out


# --------------------------------------------------------------------------
# the envelope and modal voice families: the generic harness's Envelope and
# Modal bodies, their bank slices, and a bank as a graph node under VoicePool
# --------------------------------------------------------------------------

MODAL_VOICES = 65536  # benchmarks/suite.py bench_modal_bank
MODAL_PRESETS = ("bell", "bar", "string")  # M = 12, 6 and 16 modes
# every shape, segments of 19 to 43 samples at time_scale 1: they end
# mid-block at every block size, and a t_stop lands in a curved one
ENV_TABLE = [(0.0004, 1.0, "exponential"), (0.0007, 0.3, "sinusoidal"),
             (0.0005, 0.6, "step"), (0.0009, 0.05)]
# benchmarks/suite.py:1092-1111: the envelope bank's looping program
SUITE_ENV = [(0.05, 1.0), (0.4, 0.5), (0.8, 0.75, "sinusoidal"), (1.5, 0.0)]
# the carried envelope value may differ from the plain version's by this
# many ulps where t_stop freezes a curved segment (the kernel's cosf, expf
# and logf against torch's)
EFROM_ULPS = 4
POOL_BLOCKS = 128  # blocks of note-ons in the pool slice
POOL_PER_BLOCK = N_VOICES // POOL_BLOCKS  # 1024 note-ons a block: every voice taken
POOL_HEAD = 16  # blocks of the pool slice held against the CPU render (~2 s of CPU each)
# the pool slice's render, cut from GRAPH_SECONDS for the run's time limit:
# the last note-ons land at 0.17 s and the 0.56 s program ends by 0.73
POOL_SECONDS = 1.0
PEAL = (220.0, 277.18, 329.63, 440.0)  # examples/modal_bells.py:25
BELLS_SECONDS = 4.0

# f32 operations a voice-sample of the two bodies does, counted from
# csrc/generic_bank.cu as OPS_PER_SAMPLE is (every add, multiply, divide,
# compare-select, conversion and libm call as one): the harness's 4 float
# params (5 each) and stereo mix (the active gain and the sum's one add per
# channel) 24; the polynomial pan 28, for the share of voices whose pan ramp
# is not flat over the block (the others take theirs once a block); the
# Envelope body's dt 1, the segment index 5, frac 3, each present shape's
# formula (linear 3, exponential 18, sinusoidal 7, step 0) with 2 to select
# each after the first, the transitions 20, the table sine 17, the amp 2 and
# the phase increment 5; the Modal body's EnvAr 15, drive and 1/decay 3, and
# per mode theta 2, the polynomial exp 20, the Nyquist mask 2, the
# polynomial sin and cos 24, the rotation 11
SHAPE_OPS = {0: 3, 1: 18, 2: 7, 3: 0}


def envelope_ops(envelope, moving_pans=1.0):
    shapes = list(dict.fromkeys(s.shape for s in envelope.segments))  # present, in order
    return (24 + 28 * moving_pans + 1 + 5 + 3 + sum(SHAPE_OPS[c] for c in shapes)
            + 2 * (len(shapes) - 1) + 20 + 17 + 2 + 5)


def modal_ops(n_modes, moving_pans=1.0):
    return 24 + 28 * moving_pans + 15 + 3 + 59 * n_modes


def moving_pans(torch, bank, operands, B):
    """The share of the block's voices whose pan ramp is not flat over it."""
    from knaster_tpu_torch.kernels.bank_common import ramp_flat_over_block

    g = operands["ramps"][bank.float_index("pan")]
    return 1.0 - float(ramp_flat_over_block(g, B).float().mean())


def envelope_bank(ktt, np, V, capacity, looping, seed=0):
    """An EnvelopeVoice bank on ENV_TABLE with the suite's seeded defaults
    (benchmarks/suite.py:1098-1103; amp 0.01)."""
    rng = np.random.default_rng(seed)
    d = {"freq": (220.0 * 2 ** rng.uniform(-1, 1, V)).astype(np.float32),
         "amp": np.full(V, 0.01, np.float32),
         "pan": rng.uniform(-1, 1, V).astype(np.float32),
         "time_scale": rng.uniform(0.5, 2.0, V).astype(np.float32)}
    voice = ktt.EnvelopeVoice(ktt.Envelope(0.1, ENV_TABLE, looping=looping))
    return ktt.FusedVoiceBank(voice, V, voice_defaults=d, event_capacity=capacity)


def modal_defaults(np, V, seed=0):
    """benchmarks/suite.py:980-985 (bench_modal_bank)."""
    rng = np.random.default_rng(seed)
    return {"freq": (330.0 * 2 ** rng.uniform(-1.5, 1.5, V)).astype(np.float32),
            "decay": rng.uniform(0.5, 6.0, V).astype(np.float32),
            "pan": rng.uniform(-1, 1, V).astype(np.float32),
            "amp": np.full(V, 0.01, np.float32)}


def modal_bank(ktt, np, V, capacity, preset, seed=0):
    res = getattr(ktt.ModalResonator, preset)(330.0)
    return ktt.FusedVoiceBank(ktt.ModalVoice(res), V, voice_defaults=modal_defaults(np, V, seed),
                              event_capacity=capacity)


def body_schedule(bank, V, B):
    """Per-block event lists for the Envelope and Modal bodies: an eventful
    block, an event-free one, an eventful one, an event-free one.

    Both: a freq ramp in flight for 3 blocks (voice 9), a depth-3 burst
    (set, freeze, set; voice 12), active and note-on flags (13, 14).
    Envelope: restarts mid-block (every 4th voice); restarts followed 20-49
    samples later by a t_stop, which lands in the exponential or the
    sinusoidal segment at these time_scales (voices 1 and 3 mod 4); a
    time_scale ramp over 2 blocks (voice 4).
    Modal: strikes mid-block (every 3rd voice, then the others); a decay of
    1e-6 s while ringing, where the polynomial exp underflows (voice 3); a
    freq that puts every mode past pi (voice 6)."""
    fi, ai = bank.float_index("freq"), bank.float_index("amp")
    common = [(0, 9, fi, 4, float(3 * B)), (2, 9, fi, 0, 2500.0),
              (B // 4, 12, fi, 0, 700.0), (B // 2, 12, fi, 4, 0.0),
              (3 * B // 4, 12, fi, 0, 300.0), (0, 13, ai, 3, 0.0), (0, 14, ai, 5, 0.0)]
    if "t_strike" in bank._trig_names:
        ts, di = bank.trig_index("t_strike"), bank.float_index("decay")
        ev0 = [(v % B, v, ts, 1, 0.0) for v in range(0, V, 3)]
        ev0 += common + [(B // 3, 3, di, 0, 1e-6), (B // 2, 6, fi, 0, 30000.0)]
        ev2 = [(v % B, v, ts, 1, 0.0) for v in range(1, V, 3)] + [(0, 13, ai, 3, 1.0)]
        return [ev0, None, ev2, None]
    tr, tq = bank.trig_index("t_restart"), bank.trig_index("t_stop")
    ti = bank.float_index("time_scale")
    span = max(1, B - 64)

    def restart_then_stop(first):
        out = []
        for v in range(first, V, 4):
            r = (13 * v) % span
            out += [(r, v, tr, 1, 0.0), (r + 20 + v % 30, v, tq, 1, 0.0)]
        return out

    ev0 = [(v % B, v, tr, 1, 0.0) for v in range(0, V, 4)]
    ev0 += restart_then_stop(1) + common + [(0, 4, ti, 4, float(2 * B)), (1, 4, ti, 0, 0.5)]
    ev2 = restart_then_stop(3) + [(v % B, v, tr, 1, 0.0) for v in range(2, V, 4)]
    return [ev0, None, ev2, None]


def run_generic_vs_plain(torch, ktt, bank, dev, B, blocks, label, loose=()):
    """``compare_block`` block by block over ``blocks`` from the bank's
    initial state, going on from the kernel's state; returns (max mix
    difference, max ulps, peak, final state)."""
    ctx = ktt.AudioCtx(SR, B, torch.float32)
    state = bank.init(ctx, device=dev)
    err = ulps = peak = 0.0
    for blk, evs in enumerate(blocks):
        events = None if evs is None else bank.node_events_from_lists(evs)
        operands, carry = bank.kernel_operands(ctx, state, events)
        k, e, u = compare_block(torch, "generic", bank, operands, f"{label} block {blk}",
                                loose)
        err, ulps, peak = max(err, e), max(ulps, u), max(peak, float(k[0].abs().max()))
        state, _ = bank.finish(ctx, carry, k)
    if peak == 0.0:
        fail(f"{label}: silent mix")
    return err, ulps, peak, state


def phase_family_vs_plain(torch, np, ktt, dev):
    """The generic kernel's Envelope and Modal bodies against their plain
    versions on the card at V = 1000, over ``body_schedule``'s four blocks
    at B = 64 and its first two at B = 1024 (the superblock a graph with a
    bank takes): the Envelope body looping and not; the Modal body with
    the bell, bar and string presets (M = 12, 6 and 16) at B = 64, and the
    bell one event-free block at B = 1024 from its B = 64 state. The full
    sizes are held elsewhere: the Envelope and Modal (bar) bodies at
    131,055 voices, B in {64, 1024}, by the matrix, the bell at 65,536 by
    ``modal_bank``'s slice (cut from here with the examples, for the time
    limit). Carries bit-equal but the envelope's efrom within EFROM_ULPS;
    mixes within mix_tolerance. Returns ({body: max mix difference}, efrom
    ulps)."""
    errs, ulps = {"envelope": 0.0, "modal": 0.0}, 0
    t0 = time.perf_counter()
    V = 1000
    for looping in (False, True):
        for B, n in ((BLOCK, 4), (1024, 2)):
            bank = envelope_bank(ktt, np, V, V * 3, looping, seed=V + B)
            label = f"envelope looping={looping} V={V} B={B}"
            e, u, _, st = run_generic_vs_plain(torch, ktt, bank, dev, B,
                                               body_schedule(bank, V, B)[:n], label,
                                               loose=(3,))
            if u > EFROM_ULPS:
                fail(f"{label}: efrom differs by {u} ulps (> {EFROM_ULPS})")
            if not bool((st["eseg"] == -2.0).any()):
                fail(f"{label}: no t_stop froze a voice")
            errs["envelope"], ulps = max(errs["envelope"], e), max(ulps, u)
    print(f"kernel vs plain generic envelope V={V}, looping and not, B in ({BLOCK}, 1024): "
          f"carries bit-equal, efrom within {ulps} ulps, max |mix diff| "
          f"{errs['envelope']:.3e} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    for preset in MODAL_PRESETS:
        bank = modal_bank(ktt, np, V, V * 2, preset, seed=V)
        label = f"modal {preset} V={V}"
        e, _, _, st = run_generic_vs_plain(
            torch, ktt, bank, dev, BLOCK, body_schedule(bank, V, BLOCK), f"{label} B={BLOCK}")
        errs["modal"] = max(errs["modal"], e)
        if preset == "bell":
            ctx = ktt.AudioCtx(SR, 1024, torch.float32)
            operands, _ = bank.kernel_operands(ctx, st, None)
            _, e, _ = compare_block(torch, "generic", bank, operands, f"{label} B=1024")
            errs["modal"] = max(errs["modal"], e)
    print(f"kernel vs plain generic modal {MODAL_PRESETS} (M = 12, 6, 16) V={V}, B = {BLOCK}, "
          f"and the bell at B = 1024: carries bit-equal, max |mix diff| {errs['modal']:.3e} "
          f"({time.perf_counter() - t0:.1f} s)")
    return errs, ulps


# The redesigned bank kernels against their plain versions over the shapes
# their design turns on: V = 1000, a last CTA of 239 voices (131,072 - 17:
# whole warps past the bank and a ragged one) and 131,072; B = 64 and 1024
# (tiles of 8 or 16 samples, the eventful warp rows); an eventful block,
# then an event-free one whose flat-ramp hoists meet their edge cases
# (EDGE_PARAMS); the hand sine and subtractive kernels' warp-uniform fast
# paths on both sides (HAND_KINDS); the harmonic instantiations and the
# run-time variant past them
# the full 131,072 is cut from the matrix to keep the run in its time
# limit: kernel vs plain and the slices hold every bank there at B = 64
MATRIX_VS = (1000, N_VOICES - 17)
# the (V, B) cells of the matrix: every pair but (1000, 1024), dropped
# with the user's side to keep the run within its time limit (131,055
# voices at B = 1024 keep the long block and the ragged last CTA)
MATRIX_CELLS = ((MATRIX_VS[0], BLOCK), (MATRIX_VS[1], BLOCK), (MATRIX_VS[1], 1024))
HAND_KINDS = ("sine", "sub", "fm")
MATRIX_KINDS = HAND_KINDS + ("wt", "generic-sine", "generic-fm", "generic-subtractive",
                             "generic-additive", "generic-envelope", "generic-modal")
# with the matrix's 16: 1, 17, the largest unrolled (64) and the
# run-time variant past it (65; 128 dropped with the user's side and 1024
# with the examples, for the time limit): every instantiation of
# HARMONIC_SLOTS (8, 16, 32, 64) and the run-time one
H_SWEEP = (1, 17, 64, 65)
# the params whose flat ramps the kernels hoist work on: the pan gains
# (Sine, Additive, Envelope, Modal, the hand sine), the SVF coefficients
# (Subtractive), and the hand kernels' freq and amp (and the FM kernel's
# ratio and index)
EDGE_PARAMS = ("pan", "cutoff", "q", "freq", "amp", "ratio", "index")
HAND_ONLY_PARAMS = ("freq", "amp", "ratio", "index")


def matrix_bank(ktt, np, kind, V, B, looping=False, n_harmonics=H):
    """The bank of one matrix cell: chip_smoke's seeded defaults at amp
    0.01; the Envelope body on ENV_TABLE (all four shapes), the Modal body
    on the bar (M = 6)."""
    if kind == "generic-envelope":
        return envelope_bank(ktt, np, V, V * 3, looping, seed=V + B)
    if kind == "generic-modal":
        return modal_bank(ktt, np, V, V * 2, "bar", seed=V + B)
    return make_bank(ktt, np, kind, V, capacity=V, seed=V + B, amp=0.01,
                     n_harmonics=n_harmonics)


def flat_edge_cases(torch, bank, operands, B, by_warp=False):
    """Event-free operands whose EDGE_PARAMS ramps take, by voice v mod 5: a
    glide across the block; a ramp that ended exactly at sample 0 (el ==
    dur); a zero step that ends inside the block at a target other than v0;
    a flat ramp of a signed zero (pan at v0 = -0.0 with step +0.0, which
    materializes as +0.0; the others at step -0.0); the bank's own. With
    ``by_warp`` (the hand kernels, whose hoists a warp takes only where all
    its lanes can) the cases fill two warps of three and every third warp
    keeps the bank's own ramps, with freq 0 (dt at its floor) on every
    seventh of its voices."""
    ramps = operands["ramps"].clone()
    lane = torch.arange(ramps.shape[2], device=ramps.device)
    v = lane % 5
    edged = (lane // 32) % 3 != 0 if by_warp else torch.ones_like(lane, dtype=torch.bool)
    for name in EDGE_PARAMS:
        if name not in bank._float_names or (name in HAND_ONLY_PARAMS and not by_warp):
            continue
        g = ramps[bank.float_index(name)]
        base = g[0].clone()
        cases = [
            (v == 0, (base, 0.25 * base / B + 1e-3, 0.0, 2.0 * B, 1.5 * base)),
            (v == 1, (base, 0.01, 7.0, 7.0, 0.75 * base)),
            (v == 2, (base, 0.0, 0.0, float(B // 2), 0.5 * base + 0.1)),
            (v == 3, ((-0.0, 0.0, 0.0, 4.0 * B, 0.3) if name == "pan"
                      else (base, -0.0, 0.0, 4.0 * B, base))),
        ]
        cases = [(m & edged, vals) for m, vals in cases]
        if name == "freq":
            cases.append((~edged & (lane % 7 == 6), (0.0, 0.0, 0.0, 0.0, 0.0)))
        for m, vals in cases:
            for k, x in enumerate(vals):
                g[k] = torch.where(m, x if isinstance(x, torch.Tensor)
                                   else torch.full_like(base, x), g[k])
    return dict(operands, ramps=ramps)


def steady_stages(torch, bank, state):
    """The envelope stages by warp, so that the hand kernels' steady-envelope
    hoist runs on both sides. EnvAsr (sine, subtractive): warps 0, 4, 8, ...
    sustained (stage 2, t = 1), 1, 5, ... stopped (stage 0, t = 0), 3, 7,
    ... alternate lanes sustained and stopped. EnvAr (FM), steady only where
    stopped: warps 0, 4, ... in attack (stage 1, t = 0.25), 1, 5, ...
    stopped (a warp of zero gains), 3, 7, ... alternate lanes releasing
    (stage 2, t = 0.5) and stopped. Warps 2, 6, ... keep the eventful
    block's attacks, releases and stops."""
    n = state["stage"].shape[0]
    lane = torch.arange(n, device=state["stage"].device)
    w = (lane // 32) % 4
    sus = (w == 0) | ((w == 3) & (lane % 2 == 0))
    stop = (w == 1) | ((w == 3) & (lane % 2 == 1))
    st = dict(state)
    if "rscale" in state:  # EnvAsr: sustained
        run_stage, run_t = 2.0, 1.0
    else:  # EnvAr: attack in warps 0, 4, ..., release in the alternate lanes
        run_stage = torch.where(w == 0, 1.0, 2.0)
        run_t = torch.where(w == 0, 0.25, 0.5)
    st["stage"] = torch.where(sus, run_stage, torch.where(stop, 0.0, state["stage"]))
    t_name = "et" if "et" in state else "t"
    st[t_name] = torch.where(sus, run_t, torch.where(stop, 0.0, state[t_name]))
    return st


def back_to_back(torch, mod, bank, operands, B, label):
    """Two launches into the same buffers must give bit-identical mixes:
    the in-kernel sum's order is fixed and its tickets reset."""
    if mod.KERNEL == "generic_bank":
        outs = mod.empty_outputs(operands["carry"], bank.voice.outputs, B)
    else:
        outs = mod.empty_outputs(next(operands[n] for n, _, _ in bank.STATE), B)
    mod.launch(outs, **operands)
    first = outs[0].clone()
    mod.launch(outs, **operands)
    torch.cuda.synchronize()
    if not torch.equal(first.view(torch.int32), outs[0].view(torch.int32)):
        fail(f"{label}: two launches on the same buffers gave different mixes")


def matrix_cell(torch, ktt, np, dev, kind, V, B, looping=False, n_harmonics=H):
    """One eventful and one event-free block (with the flat-ramp edge
    cases; the hand kernels also with the stages by warp) of ``kind`` at
    (V, B), kernel against plain; the event-free block also back to back.
    Returns (max |mix diff|, efrom ulps)."""
    bank = matrix_bank(ktt, np, kind, V, B, looping, n_harmonics)
    ctx = ktt.AudioCtx(SR, B, torch.float32)
    state = bank.init(ctx, device=dev)
    body = kind in ("generic-envelope", "generic-modal")
    loose = (3,) if kind == "generic-envelope" else ()
    label = f"{kind} V={V} B={B}" + (f" H={n_harmonics}" if n_harmonics != H else "") + (
        f" looping={looping}" if kind == "generic-envelope" else "")
    cpu = V == MATRIX_VS[0]
    evs = (body_schedule if body else schedule)(bank, V, B)[0]
    operands, carry = bank.kernel_operands(ctx, state, bank.node_events_from_lists(evs))
    k, err, ulps = compare_block(torch, kind, bank, operands, f"{label} eventful", loose, cpu)
    state, _ = bank.finish(ctx, carry, k)
    if kind == "generic-envelope" and not bool((state["eseg"] == -2.0).any()):
        fail(f"{label}: no t_stop froze a voice")
    hand = kind in HAND_KINDS
    if hand:
        state = steady_stages(torch, bank, state)
    operands, carry = bank.kernel_operands(ctx, state, None)
    if kind != "wt":
        operands = flat_edge_cases(torch, bank, operands, B, by_warp=hand)
    k, e, u = compare_block(torch, kind, bank, operands, f"{label} event-free", loose, cpu)
    if float(k[0].abs().max()) == 0.0:
        fail(f"{label}: silent mix")
    if V == N_VOICES - 17 and B == BLOCK:
        back_to_back(torch, kernel_module(kind), bank, operands, B, label)
    return max(err, e), max(ulps, u)


def phase_bank_matrix_vs_plain(torch, np, ktt, dev):
    """The hand sine and subtractive kernels, every generic body and the
    wavetable kernel over MATRIX_CELLS (the Envelope body looping
    and one-shot; the 1000-voice cells' plain version on the CPU), then the
    wavetable kernel and the Additive body at H in H_SWEEP, B = 64, V =
    1000 (the plain version of 131,055 voices at H = 1024 took most of the
    matrix's time; the cells cover that V at H = 16):
    carries bit-equal
    (the envelope's efrom within EFROM_ULPS), mixes within mix_tolerance,
    and at V = 131,055, B = 64 two launches on the same buffers
    bit-identical. Returns {kind: max |mix diff|}."""
    errs, ulps = {}, 0
    for kind in MATRIX_KINDS:
        t0 = time.perf_counter()
        for V, B in MATRIX_CELLS:
            for looping in ((False, True) if kind == "generic-envelope" else (False,)):
                e, u = matrix_cell(torch, ktt, np, dev, kind, V, B, looping)
                errs[kind], ulps = max(errs.get(kind, 0.0), e), max(ulps, u)
        if kind in ("wt", "generic-additive"):
            for n in H_SWEEP:
                e, _ = matrix_cell(torch, ktt, np, dev, kind, MATRIX_VS[0], BLOCK, n_harmonics=n)
                errs[kind] = max(errs[kind], e)
        print(f"kernel vs plain matrix {kind}: (V, B) in {MATRIX_CELLS}"
              + (f", H in {H_SWEEP} at V = {MATRIX_VS[0]}" if kind in ("wt", "generic-additive")
                 else "")
              + f": carries bit-equal, max |mix diff| {errs[kind]:.3e}, back to back "
              f"bit-identical ({time.perf_counter() - t0:.1f} s)")
    if ulps > EFROM_ULPS:
        fail(f"envelope matrix: efrom differs by {ulps} ulps (> {EFROM_ULPS})")
    return errs


def timed_blocks(torch, bank, ctx, state, n):
    """``n`` event-free blocks of ``bank`` from ``state``; returns (state,
    mix [n, C, B], seconds)."""
    outs = torch.empty((n, bank.voice.outputs, ctx.block_size), dtype=torch.float32,
                       device=state["fvals"].device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(n):
        state, out = bank.process(ctx, state)
        outs[b].copy_(out)
    torch.cuda.synchronize()
    return state, outs, time.perf_counter() - t0


def phase_family_slice(torch, np, ktt, dev, kind, card):
    """``envelope_bank`` (benchmarks/suite.py:1077-1136: 131,072 voices of the
    4-segment looping program, 4096 restarts in block 0) or ``modal_bank``
    (:962-1023: 65,536 bell voices, 4096 strikes in block 0) through the
    public API at B = 64, then 750 event-free blocks: every block launches
    the generic kernel, the mix is finite and not silent, and the idle
    latch is right (looping voices never idle; a struck modal voice is idle
    exactly where its ring is below the threshold, and not while it rings).
    Returns (bank, state, launches)."""
    from knaster_tpu_torch.kernels import generic_bank as gk

    ctx = ktt.AudioCtx(SR, BLOCK, torch.float32)
    if kind == "envelope":
        rng = np.random.default_rng(0)
        V = N_VOICES
        d = {"freq": (220.0 * 2 ** rng.uniform(-1, 1, V)).astype(np.float32),
             "amp": np.full(V, 0.002, np.float32),
             "pan": rng.uniform(-1, 1, V).astype(np.float32),
             "time_scale": rng.uniform(0.5, 2.0, V).astype(np.float32)}
        bank = ktt.FusedVoiceBank(
            ktt.EnvelopeVoice(ktt.Envelope(0.0, SUITE_ENV, looping=True)), V,
            voice_defaults=d, event_capacity=SUITE_CAPACITY)
        started = torch.arange(0, V, V // SUITE_CAPACITY, device=dev)
        trig = bank.trig_index("t_restart")
    else:
        V = MODAL_VOICES
        bank = modal_bank(ktt, np, V, SUITE_CAPACITY, "bell")
        started = torch.arange(SUITE_CAPACITY, device=dev)
        trig = bank.trig_index("t_strike")
    ev = bank.node_events_from_lists([(0, int(v), trig, 1, 0.0) for v in started.tolist()])
    state = bank.init(ctx, device=dev)
    torch.cuda.synchronize()
    reset_all_counts()
    state, _ = bank.process(ctx, state, events=ev)
    state, outs, secs = timed_blocks(torch, bank, ctx, state, N_BLOCKS)
    counts = read_all_counts()
    expect_counts(counts, {"generic_bank": 1 + N_BLOCKS}, f"{kind}_bank")
    peak = float(outs.abs().max())
    if not bool(torch.isfinite(outs).all()) or peak == 0.0:
        fail(f"{kind}_bank: the rendered mix is not finite or silent")
    idle = state["idle"]
    if kind == "envelope":
        if bool(idle[started].any()) or not bool((state["eseg"][started] >= 0).all()):
            fail("envelope_bank: a looping voice went idle or finished")
        latch = "no restarted (looping) voice idle or finished"
    else:
        spec = bank.spec(ctx)
        quiet = spec.idle_of(state)
        struck = torch.zeros(V, dtype=torch.bool, device=dev)
        struck[started] = True
        long_ring = struck & (state["fvals"][bank.float_index("decay")] >= 3.0)
        if not torch.equal(idle, quiet & struck) or bool(idle[long_ring].any()):
            fail(f"modal_bank: the idle latch is not the ring-out rule "
                 f"({int(idle.sum())} idle, {int((quiet & struck).sum())} quiet)")
        latch = (f"{int(idle.sum())} of {SUITE_CAPACITY} struck voices idle, exactly the "
                 f"quiet ones; none of the {int(long_ring.sum())} with decay >= 3 s")
    renders = [secs]
    for _ in range(2):
        state, _, s = timed_blocks(torch, bank, ctx, state, N_BLOCKS)
        renders.append(s)
    rates = [V * N_BLOCKS * BLOCK / t for t in renders]
    print(f"slice {kind}_bank: {V} voices, {SUITE_CAPACITY} "
          f"{'restarts' if kind == 'envelope' else 'strikes'} in block 0, {N_BLOCKS} "
          f"event-free blocks in {secs:.4f} s, mix peak {peak:.4g}, generic_bank launches "
          f"{counts['generic_bank']}; {latch}")
    print(f"slice {kind}_bank: {rates[0]:.6g} voice-samples/s event-free on {card}; two "
          f"more renders: {rates[1]:.6g}, {rates[2]:.6g}")
    return bank, state, counts["generic_bank"]


def pool_processor(torch, np, ktt, dev, chunk, n_blocks=None):
    """``pool_envelope_bank``: a FusedVoiceBank(EnvelopeVoice()) of 131,072
    voices (the default 0.56 s program, event_capacity 4096) to the graph
    out, and a VoicePool making POOL_PER_BLOCK note-ons a block at
    sample-accurate frames, each with its own freq, for the first
    ``n_blocks`` blocks (POOL_BLOCKS). Returns (processor, pool, seconds to
    queue them)."""
    g, proc = ktt.AudioProcessor.new(0, 2, ktt.AudioProcessorOptions(
        block_size=BLOCK, render_chunk_blocks=chunk), device=dev)
    bank = ktt.FusedVoiceBank(ktt.EnvelopeVoice(), N_VOICES, event_capacity=SUITE_CAPACITY)
    h = g.edit(lambda gg: gg.push(bank))
    h.to_graph_out()
    g.commit()
    pool = ktt.VoicePool(proc, h)
    freqs = (220.0 * 2 ** np.random.default_rng(0).uniform(-1, 1, N_VOICES)).tolist()
    t0 = time.perf_counter()
    for blk in range(POOL_BLOCKS if n_blocks is None else n_blocks):
        for k in range(POOL_PER_BLOCK):
            at = ktt.Seconds.from_samples(blk * BLOCK + k % BLOCK, SR)
            if pool.note_on({"freq": freqs[blk * POOL_PER_BLOCK + k]}, at=at) is None:
                fail("pool_envelope_bank: the pool ran out of voices")
    return proc, pool, time.perf_counter() - t0


def phase_pool_envelope_bank(torch, np, ktt, dev, card):
    """``pool_envelope_bank`` rendered to POOL_SECONDS on the card with superblocks
    and block by block: the generic kernel once per eventful block and per
    event-free superblock (or block), every voice released by
    ``pool.refresh()`` at the end; the first POOL_HEAD blocks held against
    the port's CPU render within mix_tolerance. Returns (launches of the
    superblocked render, realtime x of each)."""
    frames = int(POOL_SECONDS * SR)
    n_blocks = frames // BLOCK
    res = {}
    for chunk in (CHUNK, 1):
        proc, pool, t_queue = pool_processor(torch, np, ktt, dev, chunk)
        proc._ensure_compiled()
        reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio = proc.render(frames=frames, fetch=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_all_counts()
        want = POOL_BLOCKS + (event_free_pieces(proc, n_blocks - POOL_BLOCKS)
                              if chunk == CHUNK else n_blocks - POOL_BLOCKS)
        expect_counts(counts, {"generic_bank": want}, f"pool_envelope_bank chunk={chunk}")
        released = pool.refresh()
        if released != N_VOICES or pool.free_count != pool.n_voices:
            fail(f"pool_envelope_bank: refresh released {released} voices, "
                 f"{pool.free_count} free of {pool.n_voices}")
        res[chunk] = (audio, frames / SR / secs, counts["generic_bank"], t_queue)
    (a, rt_sb, launches, t_queue), (b, rt_pb, launches_pb, _) = res[CHUNK], res[1]
    peak = float(a.abs().max())
    if not bool(torch.isfinite(a).all()) or peak == 0.0:
        fail("pool_envelope_bank: output not finite or silent")
    # the state is partition-invariant (anchored ramps, per-sample bodies);
    # the kernel's mix sums in another order at another block length and in
    # eventful blocks (warp rows) than in event-free ones (CTA tiles)
    part = float((a - b).abs().max())
    if part > mix_tolerance(N_VOICES, peak):
        fail(f"pool_envelope_bank: superblocked and per-block renders differ by {part}")
    t0 = time.perf_counter()
    proc, _, _ = pool_processor(torch, np, ktt, "cpu", CHUNK, n_blocks=POOL_HEAD)
    ref = proc.render(frames=POOL_HEAD * BLOCK, fetch=False)
    t_cpu = time.perf_counter() - t0
    head = a[:, :POOL_HEAD * BLOCK].cpu()
    gap, peak = float((head - ref).abs().max()), float(ref.abs().max())
    if gap > mix_tolerance(N_VOICES, peak) or peak == 0.0:
        fail(f"pool_envelope_bank: card vs CPU over {POOL_HEAD} blocks differ by {gap} "
             f"(peak {peak}, tolerance {mix_tolerance(N_VOICES, peak)})")
    print(f"slice pool_envelope_bank: {N_VOICES} voices, {POOL_PER_BLOCK} note-ons a block "
          f"for {POOL_BLOCKS} blocks (queued in {t_queue:.2f} s), {POOL_SECONDS:g} s on {card}: "
          f"superblocks realtime x {rt_sb:.4g} ({launches} generic_bank launches), per block "
          f"realtime x {rt_pb:.4g} ({launches_pb}), the two within {part:.3e}; refresh "
          f"released all "
          f"{N_VOICES}; first {POOL_HEAD} blocks card vs CPU {gap:.3e} (peak {peak:.4g}, "
          f"CPU {t_cpu:.1f} s)")
    return launches, rt_sb, rt_pb


def modal_bells(kt, g):
    """examples/modal_bells.py:28-53: four struck bells (an EnvAr mallet into
    a 12-mode bell into Pan2), a descending peal twice."""
    def build(gg):
        strikes = []
        for i, f in enumerate(PEAL):
            mallet = gg.push(kt.EnvAr(0.001, 0.002))
            bell = gg.push(kt.ModalResonator.bell(f, decay=3.0))
            (mallet * 0.005).to(bell)
            pan = gg.push(kt.Pan2((i - 1.5) / 2.0))
            bell.to(pan)
            pan.to_graph_out()
            strikes.append(mallet.param("t_restart"))
        return strikes

    strikes = g.edit(build)
    for t0 in (0.05, 2.1):
        for i, trig in enumerate(reversed(strikes)):
            trig.trig_at(kt.Seconds.from_secs_f64(t0 + 0.35 * i))


def phase_modal_bells(torch, np, ktt, dev, card):
    """``modal_bells`` (no kernel on its path) 4 s on the card against the
    port's CPU render, within 1e-6."""
    got = {}
    for d in (dev, "cpu"):
        g, proc = ktt.AudioProcessor.new(0, 2, ktt.AudioProcessorOptions(block_size=BLOCK),
                                         dtype=torch.float32, device=d)
        modal_bells(ktt, g)
        proc._ensure_compiled()
        reset_all_counts()
        t0 = time.perf_counter()
        got[str(d)] = (np.asarray(proc.render(seconds=BELLS_SECONDS)),
                       time.perf_counter() - t0)
        if d == dev:
            expect_counts(read_all_counts(), {}, "modal_bells")
    (a, secs), (b, _) = got[str(dev)], got["cpu"]
    gap, peak = float(np.abs(a - b).max()), float(np.abs(b).max())
    if gap > 1e-6 or not np.isfinite(a).all() or peak < 1e-3:
        fail(f"modal_bells: card vs CPU differ by {gap} (peak {peak})")
    print(f"slice modal_bells: 4 bells, {BELLS_SECONDS:g} s on {card} in {secs:.3f} s "
          f"(realtime x {BELLS_SECONDS / secs:.4g}); card vs CPU {gap:.3e}, peak {peak:.4g}; "
          f"no kernel on its path")


# --------------------------------------------------------------------------
# the composable VoiceBank (the JAX package's vmap bank): plain torch ops on
# the card, no kernel of the port on its path but the voices' EnvAsr's
# --------------------------------------------------------------------------

DETUNED_VOICES = 512  # tests/golden_configs.py:85-142, each bank
DETUNED_AMP = 0.002
DETUNED_FRAMES = 9600  # the golden render's 0.2 s
# the superblocked render against the per-block one: an envelope whose
# attack sum reaches 1 on its last rounding crosses a sample apart when the
# closed form sums over a superblock; one FM and one additive attack step
DETUNED_CROSSING = DETUNED_AMP * (1.0 / (0.005 * SR) + 1.0 / (0.01 * SR)) + 1e-7
# at f32 an FM carrier takes its frequency from the modulator's sine every
# sample, and the card's sinf, torch's CPU sin and XLA's (the fixture's)
# differ by an ulp on some table indices: the carrier's u32 increment then
# truncates otherwise and its phase drifts by a few units, which moves its
# table index by one step where the drift crosses a step. One voice's step
# at full envelope: amp * 2 pi / 16384. The f32 render may miss the golden
# gate at DETUNED_F32_MISSES samples at most, each by one such step, and
# differs from the CPU render by DETUNED_F32_STEPS steps at most; at f64 a
# sine's ulp never moves an increment (DETUNED_F64_TOL)
DETUNED_TABLE_STEP = DETUNED_AMP * 2.0 * math.pi / 16384
DETUNED_F32_MISSES = 16
DETUNED_F32_STEPS = 4
DETUNED_F64_TOL = 1e-9
FM_VMAP_VOICES = 8192  # benchmarks/suite.py bench_fm_bank
PLUCKED_VOICES = 4096  # benchmarks/suite.py bench_plucked_bank
VMAP_CPU_BLOCKS = 4  # blocks of each vmap slice held against the CPU render
VMAP_BLOCKS = N_BLOCKS // 2  # each vmap slice's event-free run, cut from N_BLOCKS for the time limit
VMAP_PROFILE_BLOCKS = 8
VS_VMAP_VOICES = 1024  # tests/test_voicebank.py:175-213's kernel-vs-vmap bank
VS_VMAP_TOL = 1e-5


def detuned_banks(kt, np, dtype, dev, chunk=CHUNK):
    """Golden ``detuned_banks``'s processor on ``dev``, its schedule queued
    (tests/golden_configs.py render_detuned_banks)."""
    rng = np.random.default_rng(42)
    V = DETUNED_VOICES
    fm_d = {"freq": (220.0 * 2 ** rng.uniform(-1, 1, V)).astype(np.float32),
            "ratio": rng.choice([1.0, 2.0, 3.0], V).astype(np.float32),
            "index": rng.uniform(0.5, 2.0, V).astype(np.float32),
            "amp": np.full(V, DETUNED_AMP, np.float32)}
    wt_d = {"freq": (330.0 * 2 ** rng.uniform(-1, 1, V)).astype(np.float32),
            "amp": np.full(V, DETUNED_AMP, np.float32),
            "pan": rng.uniform(-1, 1, V).astype(np.float32)}
    harmonics = np.array([1.0, 0.6, 0.4, 0.25, 0.15, 0.08], np.float32)
    g, proc = kt.AudioProcessor.new(
        0, 2, kt.AudioProcessorOptions(block_size=BLOCK, render_chunk_blocks=chunk),
        dtype=dtype, device=dev)
    hs = {}

    def build(gg):
        hs["fm"] = gg.push(kt.VoiceBank(kt.FMVoice(), V, voice_defaults=fm_d,
                                        event_capacity=2048))
        hs["wt"] = gg.push(kt.VoiceBank(kt.AdditiveVoice(harmonics=harmonics), V,
                                        voice_defaults=wt_d, event_capacity=2048))
        hs["fm"].out([0, 0]).to_graph_out()
        hs["wt"].to_graph_out()

    g.edit(build)

    def at(n):
        return kt.Seconds.from_samples(n, SR)

    tr_fm, fr_fm = hs["fm"].voice_param("t_restart"), hs["fm"].voice_param("freq")
    tr_wt, fr_wt = hs["wt"].voice_param("t_restart"), hs["wt"].voice_param("freq")
    for v in range(V):
        tr_fm.trig_at(v, at(v % 64))
        tr_wt.trig_at(v, at((v * 3) % 64))
    for k in range(64):
        v = int(rng.integers(0, V))
        fr_fm.smooth(v, 0.02)
        fr_fm.set_at(v, float(rng.uniform(150, 700)), at(1000 + 37 * k))
        w = int(rng.integers(0, V))
        fr_wt.set_at(w, float(rng.uniform(200, 900)), at(1500 + 53 * k))
    proc._ensure_compiled()
    return proc


def phase_detuned_banks(torch, np, kt, dev, card):
    """Golden ``detuned_banks`` (two 512-voice vmap banks, FM and additive)
    at f32 and f64 on the card: the one port kernel on its path is the
    additive voices' EnvAsr's (csrc/env_asr.cu); the
    superblocked render against the fixture (the golden gate), against the
    port's CPU render and against the card's per-block render (within
    DETUNED_CROSSING); realtime x of both renders and kernel launches per
    rendered second (the profiler's count over the first
    VMAP_PROFILE_BLOCKS blocks, all eventful)."""
    for dtype, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        runs = {}
        for chunk in (CHUNK, 1):
            proc = detuned_banks(kt, np, dtype, dev, chunk)
            reset_all_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            audio = proc.render(frames=DETUNED_FRAMES, fetch=False)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            # the additive voices' EnvAsr (the FM voices' EnvAr has no kernel)
            expect_ugen_kernels(read_all_counts(), ("env_asr",), f"detuned_banks {name}")
            runs[chunk] = (audio.cpu().numpy(), DETUNED_FRAMES / SR / secs)
        n_prof = VMAP_PROFILE_BLOCKS * BLOCK
        n_k = count_kernels(torch, lambda: detuned_banks(kt, np, dtype, dev).render(
            frames=n_prof, fetch=False))
        cpu = np.asarray(detuned_banks(kt, np, dtype, "cpu").render(frames=DETUNED_FRAMES))
        (a, rt_sb), (b, rt_pb) = runs[CHUNK], runs[1]
        ref, sr = read_fixture(f"detuned_banks_{name}")
        if sr != SR or ref.shape != a.shape or not np.isfinite(a).all():
            fail(f"detuned_banks {name}: shape {a.shape} against the fixture's {ref.shape}")
        err_fix = np.abs(a.astype(np.float32) - ref)
        over = np.argwhere(err_fix > GOLDEN_GATE)
        gap_cpu = float(np.abs(a - cpu).max())
        gap_pb = float(np.abs(a - b).max())
        print(f"slice detuned_banks {name} on {card}: superblocks realtime x {rt_sb:.4g}, "
              f"per block realtime x {rt_pb:.4g}, "
              f"{None if n_k is None else n_k / (n_prof / SR)} launches per rendered s "
              f"(first {VMAP_PROFILE_BLOCKS} blocks); fixture max {float(err_fix.max()):.4e} "
              f"({len(over)} samples past the gate {GOLDEN_GATE:.4e}: [channel, frame] "
              f"{over.tolist()[:DETUNED_F32_MISSES]}); card vs CPU {gap_cpu:.4e}; "
              f"superblocks vs per block {gap_pb:.4e}; no kernel on its path")
        f32 = dtype == torch.float32
        if len(over) > (DETUNED_F32_MISSES if f32 else 0) or float(err_fix.max()) > (
                GOLDEN_GATE + DETUNED_TABLE_STEP):
            fail(f"detuned_banks {name}: {len(over)} samples past the golden gate")
        if gap_pb > DETUNED_CROSSING:
            fail(f"detuned_banks {name}: superblocked and per-block renders differ by "
                 f"{gap_pb}")
        if gap_cpu > (DETUNED_F32_STEPS * DETUNED_TABLE_STEP if f32 else DETUNED_F64_TOL):
            fail(f"detuned_banks {name}: card vs CPU differ by {gap_cpu}")


def vmap_fm_bank(kt, np):
    """benchmarks/suite.py bench_fm_bank's bank (8192 FM voices, seed 0),
    and its note-ons: every voice restarted at a staggered frame."""
    V = FM_VMAP_VOICES
    bank = kt.VoiceBank(kt.FMVoice(), V, voice_defaults=fm_defaults(np, V),
                        event_capacity=V)
    return bank, [(v % BLOCK, v, 0, 1, 0.0) for v in range(V)]


def vmap_plucked_bank(kt, np):
    """benchmarks/suite.py bench_plucked_bank's bank (4096 strings, seed 0,
    ``max_freq=1000``), the seed counter reset first, and its plucks."""
    V = PLUCKED_VOICES
    rng = np.random.default_rng(0)
    d = {"vseed": np.arange(V),
         "freq": (110.0 * 2 ** rng.uniform(0, 3, V)).astype(np.float32),
         "damp": rng.uniform(0.995, 0.999, V).astype(np.float32),
         "brightness": rng.uniform(0.4, 0.9, V).astype(np.float32)}
    kt.reset_randomness_seeds()
    bank = kt.VoiceBank(kt.PluckedVoice(max_freq=1000.0), V, voice_defaults=d,
                        event_capacity=V)
    return bank, [(v % BLOCK, v, 0, 1, 0.0) for v in range(V)]


def phase_vmap_banks(torch, np, kt, dev, card):
    """The suite's vmap cells on the card: ``fm_voice_bank`` (8192 FM voices)
    and ``plucked_bank`` (4096 strings), each ``bank.process`` over VMAP_BLOCKS
    event-free blocks at B = 64 (0.5 s) after one block of note-ons that
    sounds every voice (the suite times silence; the note-ons make the
    output checkable). No kernel of the port launches; the output is finite
    and sounds; the first VMAP_CPU_BLOCKS blocks match the port's CPU run
    within ``mix_tolerance``. Prints voice-samples/s, then the profiler's
    kernels per block and device-busy share over VMAP_PROFILE_BLOCKS
    blocks."""
    ctx = kt.AudioCtx(SR, BLOCK, torch.float32)
    for name, make in (("fm_voice_bank", vmap_fm_bank), ("plucked_bank", vmap_plucked_bank)):
        bank, notes = make(kt, np)
        V = bank.n_voices
        heads = {}
        for d in ("cpu", dev):
            st = bank.init(ctx, d)
            st, out, _ = bank.process(ctx, st, events=bank.node_events_from_lists(notes))
            head = [out]
            for _ in range(VMAP_CPU_BLOCKS - 1):
                st, out, _ = bank.process(ctx, st)
                head.append(out)
            heads[str(d)] = torch.cat(head, dim=1).cpu()
        a, b = heads[str(dev)], heads["cpu"]
        gap, peak = float((a - b).abs().max()), float(b.abs().max())
        if gap > mix_tolerance(V, peak) or peak < 1e-3:
            fail(f"{name}: card vs CPU over {VMAP_CPU_BLOCKS} blocks differ by {gap} "
                 f"(peak {peak})")
        state = bank.init(ctx, dev)
        state, _, _ = bank.process(ctx, state, events=bank.node_events_from_lists(notes))
        reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = []
        for _ in range(VMAP_BLOCKS):
            state, out, _ = bank.process(ctx, state)
            outs.append(out)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        expect_counts(read_all_counts(), {}, name)
        mix = torch.cat(outs, dim=1)
        if not bool(torch.isfinite(mix).all()) or float(mix.abs().max()) < 1e-3:
            fail(f"{name}: the event-free run is not finite or silent")

        print(f"slice {name} ({V} voices, B={BLOCK}, {VMAP_BLOCKS} event-free blocks) on "
              f"{card}: {V * VMAP_BLOCKS * BLOCK / secs:.4g} voice-samples/s (realtime x "
              f"{VMAP_BLOCKS * BLOCK / SR / secs:.4g}); card vs CPU {gap:.3e} over "
              f"{VMAP_CPU_BLOCKS} blocks (peak {peak:.4g}); no kernel of the port on its path")

        def blocks(state=state):
            s = state
            for _ in range(VMAP_PROFILE_BLOCKS):
                s, _, _ = bank.process(ctx, s)

        profile_window(torch, name, blocks, VMAP_PROFILE_BLOCKS)


def phase_kernels_vs_vmap(torch, np, kt, dev):
    """The four hand bank kernels and the generic harness's FM body on the
    card against the vmap ``VoiceBank`` of the same voice on the card, at
    V = 1024 over four eventful blocks (restarts on every other voice or
    every fifth, a release, a freq set, a smoothing ramp), mix within
    VS_VMAP_TOL per block, as tests/test_voicebank.py:175-213, 306-369 and
    452-481 hold the Pallas banks. Returns {kind: max |mix diff|}."""
    V, ctx = VS_VMAP_VOICES, kt.AudioCtx(SR, BLOCK, torch.float32)
    out = {}
    for kind in ("sine", "fm", "sub", "wt", "generic-fm"):
        fused = make_bank(kt, np, kind, V, 2048, seed=3, amp=0.01)
        vmap = kt.VoiceBank(fused.voice, V, voice_defaults=fused.voice_defaults,
                            event_capacity=2048)
        step = 5 if kind == "sine" else 2
        fi = fused.float_index("freq")
        blocks = [[(0, v, 0, 1, 0.0) for v in range(0, V, step)],
                  [(0, 7, fi, 0, 1234.0), (0, 9, fi, 4, 40.0), (10, 9, fi, 0, 300.0)]
                  + ([(17, 5, 1, 1, 0.0)] if len(fused._trig_names) > 1 else []),
                  [(3, v, 0, 1, 0.0) for v in range(1, V, 64)],
                  [(40, 11, fi, 0, 500.0)]]
        sf, sv = fused.init(ctx, dev), vmap.init(ctx, dev)
        gap, peak = 0.0, 0.0
        for k, evs in enumerate(blocks):
            sf, of = fused.process(ctx, sf, events=fused.node_events_from_lists(evs))
            sv, ov, _ = vmap.process(ctx, sv, events=vmap.node_events_from_lists(evs))
            gap = max(gap, float((of - ov).abs().max()))
            peak = max(peak, float(ov.abs().max()))
        if gap > VS_VMAP_TOL or peak < 1e-3:
            fail(f"{kind} kernel against the vmap bank: max |mix diff| {gap} (peak {peak})")
        print(f"kernel vs vmap bank {kind}: V={V}, 4 eventful blocks, max |mix diff| "
              f"{gap:.3e} (peak {peak:.4g})")
        out[kind] = gap
    return out


# -- buffers and samples ------------------------------------------------------
SAMPLER_VOICES = 16384  # benchmarks/suite.py bench_sampler_bank, bench_sampler_resample
GRAIN_SLOTS = 64  # bench_granular and bench_granular_bank
GRAIN_PLAYERS = 64  # bench_granular_bank
IR_SECONDS = 2.0  # bench_convolver: K = 2 s * 48000 / 64 = 1500 partitions
# each configuration's superblocked render (drum_machine: its bar), cut
# from the suite's 1 s to keep the run in its time limit
BUFFER_SECONDS = 0.5
# sampler_resample's, cut to keep the run in its time limit (51.9 s at 1 s
# on an H100, PERF.md §6): voices at rates of 1.67 and more still wrap
# their 1 s loop
SAMPLER_RESAMPLE_SECONDS = 0.6
# sampler_bank's, cut from the suite's 1 s to keep the run in its time
# limit (2.47e7 voice-samples/s on an H100, ~32 s a rendered second): its
# unit-rate voices wrap their 1 s loop in neither
SAMPLER_SECONDS = 0.25
# the per-block render held against the superblocked one (cut from 0.25 s
# for the time limit: the sampler banks render ~0.03x realtime)
BUFFER_PER_BLOCK_SECONDS = 0.125
BUFFER_CPU_BLOCKS = 6  # blocks of the per-block render held against the port's CPU render
DIRECT_BLOCKS = 64  # the convolver's output held against a direct convolution
DIRECT_TOL = 2e-4  # tests/test_convolver.py:44's bound against np.convolve
DRUM_STEP = 60.0 / 124.0 / 4.0  # examples/drum_machine.py: sixteenths at 124 BPM
DRUM_PATTERN = {"kick": "x...x...x..x..x.", "snare": "....x.......x...",
                "hat": "x.xxx.xx.xx.x.xx"}
DRUM_GAINS = {"kick": 0.9, "snare": 0.6, "hat": 0.35}
DRUM_PANS = {"kick": 0.0, "snare": -0.15, "hat": 0.3}


def tone_220(np):
    """The suite's source: 1 s of a 220 Hz sine at 48 kHz, f32."""
    return np.sin(2 * np.pi * 220.0 * np.arange(SR) / SR).astype(np.float32)


def buffer_processor(kt, dev, chunk, outputs=2):
    return kt.AudioProcessor.new(
        0, outputs, kt.AudioProcessorOptions(block_size=BLOCK, render_chunk_blocks=chunk),
        device=dev)


TONE_SLOPE = 2 * math.pi * 220.0 / SR  # the 220 Hz tone's steepest step a frame


def sampler_pointers(proc):
    """The per-voice read positions (f64 frames) of a graph whose one node
    is a sampler bank, else None."""
    nodes = list(proc.state["nodes"].values())
    voices = nodes[0].get("voices") if len(nodes) == 1 else None
    if not voices or "pos_int" not in voices:
        return None
    return (voices["pos_int"].double() + voices["pos_frac"].double()).cpu()


def sampler_drift(a, b, loop_len=SR):
    """The largest distance between two renders' read positions, around the
    loop."""
    d = (a - b).abs()
    return float((d.minimum(loop_len - d)).max())


def sampler_bank(kt, np, dev, chunk, resample=False):
    """bench_sampler_bank (``tiled=True``) or bench_sampler_resample (rates
    U(0.5, 1.99) from default_rng(11)): 16,384 looping voices over the 1 s
    tone at amp 0.01, every voice restarted in block 0 at a staggered
    frame (the suite times silence)."""
    V = SAMPLER_VOICES
    d = {"amp": np.full(V, 0.01, np.float32)}
    if resample:
        d["rate"] = np.random.default_rng(11).uniform(0.5, 1.99, V).astype(np.float32)
    g, proc = buffer_processor(kt, dev, chunk)
    voice = kt.SamplerVoice(tone_220(np), loop=True, **({"resample": True} if resample
                                                         else {"tiled": True}))
    bank = g.edit(lambda gg: gg.push(kt.VoiceBank(voice, V, voice_defaults=d,
                                                  event_capacity=V)))
    bank.to_graph_out()
    g.commit()
    trig = bank.voice_param("t_restart")
    for v in range(V):
        trig.trig_at(v, kt.Seconds.from_samples(v % BLOCK, SR))
    return proc, V


def grain_cloud(kt, np, dev, chunk, players=1):
    """bench_granular (one player: 64 grains at 400 Hz, grain_dur 0.08,
    pos_jitter 0.3, rate_jitter 0.5, amp 0.2) or bench_granular_bank (64
    such players, densities 400 * 2^U(-0.5, 0.5) from default_rng(7),
    max_rate 2.0, amp 0.2 / 64), over the 1 s tone."""
    src = kt.Buffer(tone_220(np)[None, :], SR)
    g, proc = buffer_processor(kt, dev, chunk)
    rng = np.random.default_rng(7)

    def build(gg):
        for i in range(players):
            if players == 1:
                kw = dict(density=400.0, amp=0.2)
            else:
                kw = dict(seed=i, density=float(400.0 * 2 ** rng.uniform(-0.5, 0.5)),
                          max_rate=2.0, amp=0.2 / players)
            gg.push(kt.GrainPlayer(src, grains=GRAIN_SLOTS, grain_dur=0.08, pos_jitter=0.3,
                                   rate_jitter=0.5, **kw)).to_graph_out()

    g.edit(build)
    return proc, players


def convolver_ir(np):
    """bench_convolver's IR: 2 s stereo from default_rng(0), exp(-3t) * 0.02."""
    L = int(IR_SECONDS * SR)
    t = np.arange(L, dtype=np.float32) / SR
    return (np.random.default_rng(0).standard_normal((2, L)).astype(np.float32)
            * np.exp(-3.0 * t)[None, :] * 0.02)


def convolver(kt, np, dev, chunk):
    """bench_convolver: WhiteNoise(seed=5) into the 2 s stereo IR."""
    g, proc = buffer_processor(kt, dev, chunk)

    def build(gg):
        n = gg.push(kt.WhiteNoise(seed=5))
        cv = gg.push(kt.Convolver(convolver_ir(np)))
        n.to(cv)
        cv.to_graph_out()

    g.edit(build)
    return proc, 1


def drum_kit(np):
    """examples/drum_machine.py's procedural kit."""
    t = np.arange(int(0.25 * SR)) / SR
    kick = np.sin(2 * np.pi * np.cumsum(120.0 * np.exp(-t * 18.0) + 45.0) / SR) * np.exp(-t * 14.0)
    t = np.arange(int(0.18 * SR)) / SR
    snare = (0.7 * np.random.default_rng(2).standard_normal(len(t)) * np.exp(-t * 28.0)
             + 0.5 * np.sin(2 * np.pi * 185.0 * t) * np.exp(-t * 40.0))
    t = np.arange(int(0.07 * SR)) / SR
    hat = 0.5 * np.diff(np.random.default_rng(3).standard_normal(len(t)), prepend=0.0) * np.exp(
        -t * 60.0)
    return {"kick": kick.astype(np.float32), "snare": snare.astype(np.float32),
            "hat": hat.astype(np.float32)}


def drum_machine(kt, np, dev, chunk):
    """examples/drum_machine.py for one bar: three ``VoiceBank(SamplerVoice(
    tiled=True, loop=False))`` of 4 voices, the 16-step pattern scheduled
    up front by ``set_after``, round-robin over each bank's voices."""
    g, proc = buffer_processor(kt, dev, chunk)
    kits, n_voices = drum_kit(np), 4

    def build(gg):
        banks = {}
        for name, data in kits.items():
            banks[name] = gg.push(kt.VoiceBank(
                kt.SamplerVoice(data, loop=False, tiled=True, attack=0.0005, release=0.01),
                n_voices, voice_defaults={
                    "amp": np.full(n_voices, DRUM_GAINS[name], np.float32),
                    "pan": np.full(n_voices, DRUM_PANS[name], np.float32)}))
            banks[name].to_graph_out()
        return banks

    banks = g.edit(build)
    hits = dict.fromkeys(kits, 0)
    for step in range(16):
        for name, pat in DRUM_PATTERN.items():
            if pat[step] == "x":
                banks[name].voice_param("t_restart").set_after(
                    hits[name] % n_voices, None, step * DRUM_STEP + 0.01)
                hits[name] += 1
    return proc, 3 * n_voices


# the kernels of the UGens on each buffer configuration's path: the sampler
# voices' EnvAsr
BUFFER_KERNELS = {"sampler_bank": ("env_asr",), "sampler_resample": ("env_asr",),
                  "drum_machine": ("env_asr",)}
BUFFER_CONFIGS = {
    # name: (build function, seconds of the superblocked render, the gate of card vs
    # CPU and of superblocks vs per block as a function of (V, peak),
    # voice-samples/s or realtime x, blocks held against the CPU)
    # the sampler banks: the mix of V voices summed in another order, and
    # (below) each voice's read position as far apart as the two renders'
    # pointers are, at the tone's steepest slope and the voices' amp
    "sampler_bank": (sampler_bank, SAMPLER_SECONDS, mix_tolerance, "voices",
                     BUFFER_CPU_BLOCKS),
    "sampler_resample": (lambda kt, np, dev, chunk: sampler_bank(kt, np, dev, chunk, True),
                         SAMPLER_RESAMPLE_SECONDS, mix_tolerance, "voices", BUFFER_CPU_BLOCKS),
    # the grains: the card's cosf, sinf and exp2f against the CPU's, an ulp
    # on some inputs, moving a grain's frozen step and pan gains
    "granular": (grain_cloud, BUFFER_SECONDS, lambda V, peak: 1e-5 * max(1.0, peak),
                 "realtime", BUFFER_CPU_BLOCKS),
    "granular_bank": (lambda kt, np, dev, chunk: grain_cloud(kt, np, dev, chunk, GRAIN_PLAYERS),
                      BUFFER_SECONDS, lambda V, peak: 1e-5 * max(1.0, peak), "realtime",
                      BUFFER_CPU_BLOCKS),
    # 1500 partitions summed in another order: the reference's own bound
    # against the exact convolution
    "convolver": (convolver, BUFFER_SECONDS, lambda V, peak: DIRECT_TOL, "realtime",
                  BUFFER_CPU_BLOCKS),
    # unit-rate copies of the kit's samples; the CPU render covers the first
    # hits (block 7 on)
    "drum_machine": (drum_machine, 16 * DRUM_STEP + 0.5, lambda V, peak: 1e-6 * max(1.0, peak),
                     "realtime", 4 * BUFFER_CPU_BLOCKS),
}


def check_direct_convolution(torch, np, kt, card_audio):
    """The convolver cell's first DIRECT_BLOCKS blocks against np.convolve in
    f64 of the same WhiteNoise(seed=5) stream (rendered alone on the CPU)
    with the same IR: the reference's bound, which TF32 products would
    break. Returns the gap."""
    g, proc = kt.AudioProcessor.new(0, 1, kt.AudioProcessorOptions(block_size=BLOCK),
                                    device="cpu")
    g.edit(lambda gg: gg.push(kt.WhiteNoise(seed=5)).to_graph_out())
    n = DIRECT_BLOCKS * BLOCK
    x = np.asarray(proc.render(frames=n))[0].astype(np.float64)
    ir = convolver_ir(np).astype(np.float64)
    direct = np.stack([np.convolve(x, ir[c])[:n] for c in range(2)])
    return float(np.abs(card_audio[:, :n] - direct).max())


def phase_buffers(torch, np, kt, dev, card):
    """The buffer-and-sample family on the card at the suite's widths, 48 kHz,
    B = 64, each configuration through ``AudioProcessor.render``: the
    superblocked render (its 1 s; drum_machine its bar and 0.5 s of tail)
    timed, voice-samples/s for the sampler banks (voices x samples / wall
    s) and realtime x for the graphs; the per-block render
    (``render_chunk_blocks=1``) of its first BUFFER_PER_BLOCK_SECONDS,
    timed, against the superblocked render; its first BUFFER_CPU_BLOCKS
    blocks against the port's CPU render of them, per block; no kernel of
    the port launches; the output finite and sounding; the profiler's
    kernels a block and device-busy share over VMAP_PROFILE_BLOCKS blocks
    after the first. ``granular_bank``'s 64 players must run as one batched
    plan item; the convolver runs with TF32 switched on by the caller
    (``torch.set_float32_matmul_precision("high")``) and must still meet a
    direct f64 convolution within the reference's 2e-4."""
    for name, (build, seconds, gate, metric, cpu_blocks) in BUFFER_CONFIGS.items():
        t_cfg = time.perf_counter()
        prev_precision = torch.get_float32_matmul_precision()
        if name == "convolver":
            torch.set_float32_matmul_precision("high")  # the caller's TF32: scoped off
        try:
            frames = int(round(seconds * SR / BLOCK)) * BLOCK
            proc, V = build(kt, np, dev, CHUNK)
            proc._ensure_compiled()
            batched = max((len(it) for k, it in proc.compiled.plan if k == "batch"), default=0)
            if name == "granular_bank" and batched != GRAIN_PLAYERS:
                fail(f"granular_bank: the players ran as a batch of {batched}, not "
                     f"{GRAIN_PLAYERS}")
            pb_frames = min(frames, int(BUFFER_PER_BLOCK_SECONDS * SR) // BLOCK * BLOCK)
            reset_all_counts()
            # in two calls, so that the pointers can be read where the
            # per-block render ends
            head, secs = render_timed(torch, proc, pb_frames / SR)
            pointers = sampler_pointers(proc)
            tail, tail_secs = render_timed(torch, proc, (frames - pb_frames) / SR)
            secs += tail_secs
            # the sampler voices' EnvAsr
            expect_ugen_kernels(read_all_counts(), BUFFER_KERNELS.get(name, ()), name)
            audio = torch.cat([head, tail], dim=1).cpu().numpy()
            proc_pb, _ = build(kt, np, dev, 1)
            per_block, pb_secs = render_timed(torch, proc_pb, pb_frames / SR)
            per_block = per_block.cpu().numpy()
            # the resampler's f32 pointer rounds at every render call's
            # block ends: the partitions read a few ulps apart
            drift = (None if pointers is None else
                     float(sampler_drift(pointers, sampler_pointers(proc_pb))))
            cpu_frames = cpu_blocks * BLOCK
            proc_cpu, _ = build(kt, np, "cpu", 1)
            cpu = np.asarray(proc_cpu.render(frames=cpu_frames))
            direct = check_direct_convolution(torch, np, kt, audio) if name == "convolver" else None
        finally:
            torch.set_float32_matmul_precision(prev_precision)
        peak = float(np.abs(audio).max())
        if not np.isfinite(audio).all() or peak < 1e-3:
            fail(f"{name}: the render is not finite or silent (peak {peak})")
        gap_pb = float(np.abs(audio[:, :pb_frames] - per_block).max())
        gap_cpu = float(np.abs(per_block[:, :cpu_frames] - cpu).max())
        tol = gate(V, peak) + (0.0 if drift is None else V * 0.01 * TONE_SLOPE * drift)
        if gap_pb > tol or gap_cpu > tol:
            fail(f"{name}: superblocks vs per block {gap_pb}, card vs CPU {gap_cpu} (gate "
                 f"{tol})")
        if direct is not None and direct > DIRECT_TOL:
            fail(f"convolver: {direct} from a direct convolution (bound {DIRECT_TOL})")

        def more(proc=proc_pb):
            proc.render(frames=VMAP_PROFILE_BLOCKS * BLOCK, fetch=False)

        k_block, busy = profile_window(torch, name, more, VMAP_PROFILE_BLOCKS)
        rate = (f"{V * frames / secs:.4g} voice-samples/s (realtime x {frames / SR / secs:.4g})"
                if metric == "voices" else f"realtime x {frames / SR / secs:.4g}")
        print(f"slice {name} on {card}: {rate} superblocked over {frames / SR:.3f} s; per "
              f"block realtime x {pb_frames / SR / pb_secs:.4g} over {pb_frames / SR:.3f} s; "
              f"{k_block} kernels a block and {busy}% busy (per block, "
              f"{VMAP_PROFILE_BLOCKS} blocks); superblocks vs per block {gap_pb:.3e}, card vs "
              f"CPU {gap_cpu:.3e} over {cpu_blocks} blocks (gate {tol:.3e}, peak "
              f"{peak:.4g})" + (f"; batched players {batched}" if name == "granular_bank" else "")
              + (f"; pointer drift {drift:.4g} frames" if drift is not None else "")
              + (f"; direct f64 convolution {direct:.3e} over {DIRECT_BLOCKS} blocks with TF32 "
                 f"on outside (bound {DIRECT_TOL})" if direct is not None else "")
              + f"; port kernels {BUFFER_KERNELS.get(name) or 'none'} "
              f"({time.perf_counter() - t_cfg:.1f} s)")


# --------------------------------------------------------------------------
# the live path: StreamBackend, async recompile, the stream-warmed programs
# --------------------------------------------------------------------------

LIVE_CHUNK = 64  # benchmarks/realtime_soak.py's chunk (SOAK_CHUNK), in blocks
LIVE_SECONDS = 8.0  # each scenario's soak: wall seconds of live control
LIVE_CPU_GATE = 1e-6  # the card against the port's CPU render, x max(1, peak)
# the cascade's: each stage's output sets the next stage's u32 increment,
# and the card's sinf differs from the CPU's by an ulp on some inputs (PR
# 12's detuned_banks finding), which 255 FM stages amplify; the chain
# kernel is held bit-equal to the scan executor on the card instead
LIVE_FM_GATE = 1e-3
LIVE_WRITTEN = 0.8  # the ring's frames_written >= this x wall x 48 kHz
LIVE_FREE_CHECKS = 4  # event-free sine-kernel calls held against the plain version
LIVE_CHECKPOINT_BLOCKS = 16
LIVE_PROGRAMS = (("get_evchunk_fn", "evchunk"), ("get_float_evchunk_fn", "float_evchunk"),
                 ("get_float_fn", "float"), ("get_full_super_fn", "full_super"),
                 ("get_full_super_scan_fn", "full_super_scan"), ("get_full_scan_fn", "full_scan"),
                 ("get_super_fn", "super"), ("get_super_scan_fn", "super_scan"),
                 ("get_scan_fn", "scan"))


# (instances, B, dtype) the pink noise kernel is held at against its plain
# version: the live `ir` chunk's blocks and superblocks (one instance, f32),
# a batched block, and f64
PINK_CASES = ((1, BLOCK, "f32"), (1, 1024, "f32"), (1, 4096, "f32"), (4, BLOCK, "f32"),
              (1, BLOCK, "f64"), (2, 1088, "f64"))


def pink_noise_vs_plain(torch, np, dev, card):
    """The pink noise kernel against ``pink_noise_plain`` on the card, on
    the same random states (counters at every phase, frames near the u32
    wrap) at PINK_CASES: the output and every state leaf bit-equal. Then its
    device ms at B = 64 (in a CUDA graph), the plain version's and the bound.
    Returns (max |err|, ms, plain_ms, bound_ms, bound_by)."""
    from knaster_tpu_torch.kernels import pink_noise as pk

    rng = np.random.default_rng(19)
    err, states = 0.0, {}
    for n, B, dt in PINK_CASES:
        dtype = torch.float32 if dt == "f32" else torch.float64
        state = {
            "seed": torch.from_numpy(rng.integers(0, 2**32, n).astype(np.uint32)
                                     .view(np.int32)).to(dev),
            "frame": torch.from_numpy(rng.integers(2**32 - 3 * B, 2**32, n)
                                      .astype(np.uint32).view(np.int32)).to(dev),
            "whites": torch.from_numpy(rng.uniform(-1, 1, (n, pk.OCTAVES))).to(dev, dtype),
            "always_on": torch.from_numpy(rng.uniform(-1, 1, n)).to(dev, dtype),
            "counter": torch.from_numpy(rng.integers(1, 257, n).astype(np.int32)).to(dev),
            "pink": torch.from_numpy(rng.uniform(-3, 3, n)).to(dev, dtype),
        }
        states[n, B, dt] = state
        got_state, got = pk.launch(state, B)
        want_state, want = pk.pink_noise_plain(state, B)
        torch.cuda.synchronize()
        words = lambda x: x.view(torch.int64) if x.dtype == torch.float64 else bits(x)  # noqa: E731
        same = torch.equal(words(got), words(want)) and all(
            torch.equal(words(got_state[k]), words(want_state[k])) for k in want_state)
        if not same or not bool(torch.isfinite(got).all()):
            fail(f"pink_noise n={n} B={B} {dt}: the kernel differs from the plain version "
                 f"by {float((got - want).abs().max())}")
        err = max(err, float((got - want).abs().max()))
    n, B = 1, BLOCK
    state = states[n, B, "f32"]
    ms = time_graph(torch, lambda: pk.launch(state, B), 100)
    eager_ms = time_call(torch, lambda: pk.launch(state, B), 100)
    plain_ms = time_call(torch, lambda: pk.pink_noise_plain(state, B), 20)
    out_state, out = pk.launch(state, B)
    b_ms, b_by = bound(tensor_bytes(state, out_state, out), OPS_PER_SAMPLE["pink_noise"] * n * B)
    print(f"pink_noise on {card}: kernel bit-equal to the plain version at (instances, B, "
          f"dtype) {PINK_CASES}; B={B}: kernel {ms:.4f} ms (eager {eager_ms:.4f}), plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by}, "
          f"{OPS_PER_SAMPLE['pink_noise']} operations a sample)")
    return err, ms, plain_ms, b_ms, b_by


def soak_module():
    """tools/realtime_soak.py, the port's soak loop."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import realtime_soak

    return realtime_soak


class ProgramLog:
    """Within ``with``, each program the runner calls appends its name (the
    processor module's getters wrapped); ``names`` is the list."""

    def __init__(self):
        import knaster_tpu_torch.graph.processor as tP

        self.module, self.names, self.saved = tP, [], {}

    def __enter__(self):
        for attr, name in LIVE_PROGRAMS:
            orig = self.saved[attr] = getattr(self.module, attr)

            def getter(*a, _orig=orig, _name=name, **k):
                fn = _orig(*a, **k)
                if fn is None:
                    return None

                def call(*x, **y):
                    self.names.append(_name)
                    return fn(*x, **y)

                return call

            setattr(self.module, attr, getter)
        return self

    def __exit__(self, *exc):
        for attr, orig in self.saved.items():
            setattr(self.module, attr, orig)


def build_programs_like(proc, like):
    """Build, without running them, the programs of the compile ``like``
    (a warmed one) on ``proc``'s own compile: a reference render then takes
    the warmed render's partition for a fraction of the warm's time."""
    from knaster_tpu_torch.graph import compile as C

    proc._ensure_compiled()
    cg = proc.compiled
    for key in like.super_fns:
        if isinstance(key, int):
            C.get_super_fn(cg, key)
        elif key[0] == "full":
            C.get_full_super_fn(cg, key[1])
        else:
            C.get_full_super_scan_fn(cg, key[1])
    for n in like.evchunk_fns:
        C.get_evchunk_fn(cg, n)
    for key in like.float_fns:
        C.get_float_fn(cg) if key == 1 else C.get_float_evchunk_fn(cg, int(key[2:]))
    cg.full_scan_warm |= like.full_scan_warm


def live_processor(kt, rs, dev, scenario, like=None):
    """The soak's graph and processor on ``dev``, warmed as the stream warms
    it (``warm_for_stream`` at the soak's chunk), or given the programs of
    the warmed compile ``like``; returns (graph, processor, handles, the
    seeded rng the script goes on drawing from)."""
    import numpy as np

    rng = np.random.default_rng(0)
    g, proc = rs.processor(kt, dev)
    handles = g.edit(lambda gg: rs.build(kt, gg, scenario, rng))
    if like is None:
        proc.warm_for_stream(LIVE_CHUNK)
    else:
        build_programs_like(proc, like)
    return g, proc, handles, rng


def live_script(kt, scenario, g, handles, rng):
    """The scenario's events for the warmed bounce, one callable a chunk,
    at fixed seeded frames: asap batches land in block 0 of the next chunk
    (the eventful-chunk programs), ``*_at`` inside a chunk (the eventful
    superblock, or for the capped bank the loop of eventful 16-block
    superblocks)."""
    C = LIVE_CHUNK * BLOCK

    def at(n):
        return kt.Seconds.from_samples(int(n), SR)

    if scenario == "bank":
        trig, rel, freq = (handles.voice_param(n) for n in ("t_restart", "t_release", "freq"))

        def c0():
            for v in range(64):
                trig.trig(v)
            for v in range(8):
                freq.set(v, float(rng.uniform(200, 2000)))

        def c1():
            frames = rng.integers(C, 2 * C, 136)
            for i in range(64):
                trig.trig_at(64 + i, at(frames[i]))
                rel.trig_at(i, at(frames[64 + i]))
            for i in range(8):
                freq.set_at(64 + i, float(rng.uniform(200, 2000)), at(frames[128 + i]))

        return [c0, c1]
    if scenario == "cascade":
        def c0():  # a float batch: the chain kernel's float-event block
            handles[0].param("freq").set(float(rng.uniform(80, 160)))

        def c1():
            handles[0].param("freq").set_at(float(rng.uniform(80, 160)),
                                            at(C + int(rng.integers(0, C))))
            handles[17 % len(handles)].param("reset_phase").trig_at(
                at(C + int(rng.integers(0, C))))

        return [c0, c1]
    if scenario == "ir":
        dw = handles.param("dry_wet")

        def chunk(c):
            def go():
                for _ in range(4):
                    dw.set_at(float(rng.uniform(0.1, 0.9)), at(c * C + int(rng.integers(0, C))))
            return go

        return [chunk(0), chunk(1)]

    def c1():  # a push and a free between the chunks (a synchronous recompile)
        def push_one(gg):
            s = gg.push(kt.SinWt(float(rng.uniform(150, 2000))))
            (s * 0.002).to_graph_out()

        g.edit(push_one)
        g.edit(lambda gg: handles[0].free())

    return [lambda: None, c1]


class SineCheck:
    """The live bank's kernel wrapper, replaced: a call whose block is
    eventful, and the first LIVE_FREE_CHECKS event-free ones, also run the
    plain version on copies of their operands, on the card; state must be
    bit-equal and the mix within ``mix_tolerance``. Keeps the first
    eventful superblock call's operands (for its timing)."""

    def __init__(self, torch, mod):
        self.torch, self.mod = torch, mod
        self.err, self.checked, self.free, self.superblock_ops = 0.0, [], 0, None

    def __call__(self, **ops):
        torch = self.torch
        eventful = ops["rounds"] is not None
        check = eventful or self.free < LIVE_FREE_CHECKS
        self.free += not eventful
        copy = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in ops.items()}
        if eventful and ops["block_size"] > BLOCK and self.superblock_ops is None:
            self.superblock_ops = copy
        ref = self.mod.sine_bank_plain(**copy) if check else None
        out = self.mod.sine_bank(**ops)
        if check:
            label = f"live bank, {'eventful' if eventful else 'event-free'} B={ops['block_size']}"
            for n, (a, b) in enumerate(zip(out[1:], ref[1:])):
                if not torch.equal(bits(a), bits(b)):
                    fail(f"{label}: state output {n} differs from the plain version")
            err = float((out[0] - ref[0]).abs().max())
            peak = float(ref[0].abs().max())
            if not bool(torch.isfinite(out[0]).all()) or err > mix_tolerance(N_VOICES, peak):
                fail(f"{label}: mix differs from the plain version by {err} (peak {peak})")
            self.err = max(self.err, err)
            self.checked.append((eventful, ops["block_size"]))
        return out


class ChainSpy:
    """``kernels.chain_kernel.chain_kernel`` wrapped within ``with``: keeps
    the first call's (program, operands) at the native block."""

    def __init__(self):
        self.kck, self.first = stage_module("chain_kernel"), None

    def __enter__(self):
        real = self.real = self.kck.chain_kernel

        def spy(program, **ops):
            if self.first is None and ops["block_size"] == BLOCK:
                self.first = (program, ops)
            return real(program, **ops)

        self.kck.chain_kernel = spy
        return self

    def __exit__(self, *exc):
        self.kck.chain_kernel = self.real


def live_bounce(torch, kt, rs, dev, scenario, chain_mode=None, like=None):
    """The warmed bounce of ``scenario`` on ``dev`` (or one given the
    programs of ``like``): its two scripted chunks through ``render`` (the
    stream's call), no threads. Returns (audio [2, 2 * 64 * B] numpy, the
    programs each chunk took, the warmed compile)."""
    import knaster_tpu_torch.graph.chain_kernel as tck

    saved, tck._MODE = tck._MODE, chain_mode
    try:
        g, proc, handles, rng = live_processor(kt, rs, dev, scenario, like)
        warmed = proc.compiled
        outs, programs = [], []
        for events in live_script(kt, scenario, g, handles, rng):
            events()
            with ProgramLog() as log:
                outs.append(proc.render(frames=LIVE_CHUNK * BLOCK, fetch=False))
            programs.append(log.names or ["blocks"])
        audio = torch.cat(outs, dim=1).cpu().numpy()
    finally:
        tck._MODE = saved
    return audio, programs, warmed


def phase_live(torch, np, kt, dev, card):
    """The live path on the card (``StreamBackend``, async recompile, the
    stream-warmed programs, checkpoints), driven by the JAX package's
    realtime soak's four scenarios at their sizes (tools/realtime_soak.py).

    (a) The warmed bounce: each scenario warmed as a stream warms it, then
    two scripted 64-block chunks through ``render`` with no threads; prints
    the programs each chunk took and the kernels' launches. ``bank``: every
    eventful call of the sine kernel (the eventful block 0 at B = 64, the
    eventful 1024-sample superblocks) and the first event-free ones held
    against the plain version on the card. ``cascade``: the chain kernel's
    render (its float-event block 0 included) bit-equal to the scan
    executor's (``_MODE = "0"``), and against the port's CPU render
    (LIVE_FM_GATE); ``ir`` and ``edit`` against the port's CPU render
    (LIVE_CPU_GATE).
    (b) The live soak: each scenario streamed LIVE_SECONDS with its control
    loop; one JSON row each; the ring's frames_written at least
    LIVE_WRITTEN x wall x 48 kHz, the peak finite and above zero, every edit
    heard, no thread failed; underruns reported, not gated.
    (c) After ``bank``: ``save_state``, ``load_state`` into a fresh
    processor, LIVE_CHECKPOINT_BLOCKS blocks bit-equal to the original's
    next ones. (d) The pink noise kernel (``ir``'s source) bit-equal to its
    plain version at PINK_CASES, and timed. Returns the kernels line's three
    live rows."""
    import tempfile

    from knaster_tpu_torch.kernels import sine_bank

    rs = soak_module()
    kck = stage_module("chain_kernel")
    rows = {}
    # (a) the warmed bounce
    check = SineCheck(torch, sine_bank)
    for scenario in rs.SCENARIOS:
        t0 = time.perf_counter()
        reset_all_counts()
        if scenario == "bank":
            g, proc, handles, rng = live_processor(kt, rs, dev, scenario)
            proc.compiled.entries[handles.node_id].ugen.kernel = check
            programs = []
            for events in live_script(kt, scenario, g, handles, rng):
                events()
                with ProgramLog() as log:
                    proc.render(frames=LIVE_CHUNK * BLOCK, fetch=False)
                programs.append(log.names or ["blocks"])
            counts = read_all_counts()
            if not any(e and b == 16 * BLOCK for e, b in check.checked):
                fail(f"live bank: no eventful 1024-sample superblock was checked: "
                     f"{check.checked}")
            gap = f"the sine kernel vs plain over {len(check.checked)} calls {check.err:.3e}"
        else:
            with ChainSpy() as spy:
                audio, programs, warmed = live_bounce(torch, kt, rs, dev, scenario)
            counts = read_all_counts()
            cpu, cpu_programs, _ = live_bounce(torch, kt, rs, "cpu", scenario, like=warmed)
            if cpu_programs != programs and scenario != "cascade":
                fail(f"live {scenario}: the CPU took {cpu_programs}, the card {programs}")
            peak = float(np.abs(audio).max())
            err = float(np.abs(audio - cpu).max())
            gate = (LIVE_FM_GATE if scenario == "cascade" else LIVE_CPU_GATE) * max(1.0, peak)
            if not np.isfinite(audio).all() or err > gate:
                fail(f"live {scenario}: card vs CPU {err} (peak {peak}, gate {gate})")
            gap = f"card vs CPU {err:.3e} (peak {peak:.4g}, gate {gate:.1e})"
            if scenario == "cascade":
                scan, scan_programs, _ = live_bounce(torch, kt, rs, dev, scenario, "0",
                                                     like=warmed)
                if not np.array_equal(bits(torch.from_numpy(audio)),
                                      bits(torch.from_numpy(scan))):
                    fail("live cascade: the chain kernel's render differs from the scan "
                         f"executor's by {float(np.abs(audio - scan).max())}")
                if programs[0] != ["float_evchunk"] or counts["chain_kernel"] == 0:
                    fail(f"live cascade: block 0's float batch took {programs[0]} with "
                         f"{counts['chain_kernel']} chain kernel launches")
                chain_call = spy.first
                gap += (f"; the chain kernel bit-equal to the scan executor over "
                        f"{2 * LIVE_CHUNK} blocks (the scan executor took {scan_programs})")
        print(f"live bounce {scenario} on {card}: chunks took {programs}; {gap} "
              f"({time.perf_counter() - t0:.1f} s)")
        print(f"live bounce {scenario} launches (its warm included): "
              f"{ {k: n for k, n in counts.items() if n} }")
    # (b) the live soak, and (c) the checkpoint after bank; a soak compiles
    # its own renderers (the bounce's bank UGen holds the checking kernel)
    from knaster_tpu_torch.graph.compile import clear_program_cache

    live_counts = {}
    for scenario in rs.SCENARIOS:
        clear_program_cache()
        reset_all_counts()
        row, proc = rs.soak(kt, torch, scenario, LIVE_SECONDS, dev)
        live_counts[scenario] = read_all_counts()
        row["card"] = card
        row["launches"] = {k: n for k, n in live_counts[scenario].items() if n}
        print(json.dumps(row))
        floor = LIVE_WRITTEN * row["wall_s"] * SR
        if row["frames_written"] < floor:
            fail(f"live {scenario}: the ring took {row['frames_written']} frames in "
                 f"{row['wall_s']:.2f} s (floor {floor:.0f})")
        if not (math.isfinite(row["peak"]) and row["peak"] > 0):
            fail(f"live {scenario}: peak {row['peak']}")
        if scenario == "edit" and (row["edits_not_audible"] or not row["edits"]):
            fail(f"live edit: {row['edits_not_audible']} of {row['edits']} edits never "
                 "became audible")
        if scenario == "edit":
            print(f"live edit on {card}: edit-to-audible median "
                  f"{row['edit_to_audible_s_median']:.3f} s (0.384 s before the program "
                  f"cache, PERF.md §5); {row['cache_hits']} of {row['compiles']} compiles were "
                  f"program-cache hits, compile median {row['compile_ms_median']:.1f} ms, "
                  f"warm median {row['warm_ms_median']:.1f} ms")
        if scenario == "bank":
            proc.render(frames=LIVE_CHUNK * BLOCK)  # what the control loop queued last
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "bank.ckpt")
                proc.save_state(path)
                g2, fresh = rs.processor(kt, dev)
                g2.edit(lambda gg: rs.build(kt, gg, "bank", np.random.default_rng(0)))
                fresh.load_state(path)
            n = LIVE_CHECKPOINT_BLOCKS * BLOCK
            a = proc.render(frames=n, fetch=False)
            b = fresh.render(frames=n, fetch=False)
            if not torch.equal(bits(a), bits(b)):
                fail(f"live checkpoint: the restored bank differs by "
                     f"{float((a - b).abs().max())}")
            print(f"live checkpoint on {card}: {LIVE_CHECKPOINT_BLOCKS} blocks after "
                  f"load_state bit-equal to the original's (peak {float(a.abs().max()):.4g})")
    for scenario, name in (("bank", "sine_bank"), ("cascade", "chain_kernel"),
                           ("ir", "pink_noise")):
        if not live_counts[scenario][name]:
            fail(f"live {scenario}: {name} never launched in the soak")
    # the three kernels at the live path's shapes
    mod = sine_bank
    ops = check.superblock_ops
    B = ops["block_size"]
    outs = mod.empty_outputs(ops["phase"], B)
    ms = time_graph(torch, lambda: mod.launch(outs, **ops), 20)
    plain_ms = time_call(torch, lambda: mod.sine_bank_plain(**ops), 1)
    D = ops["rounds"].shape[2]
    per_sample = OPS_PER_SAMPLE["sine_bank"] + 15 * D
    b_ms, b_by = bound(tensor_bytes(ops, written(mod, outs)), per_sample * N_VOICES * B)
    print(f"timing sine_bank live eventful superblock V={N_VOICES} B={B} D={D} on {card}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}, "
          f"{per_sample} f32 operations a voice-sample: the general count and 15 a "
          "breakpoint round)")
    rows["sine_bank"] = kernel_row("sine_bank", live_counts["bank"]["sine_bank"], check.err,
                                   ms, plain_ms, b_ms, b_by, label="sine_bank:live_bank")
    program, cops = chain_call
    outs = kck.empty_outputs(program, dev, cops["K"], cops["block_size"])
    ms = time_call(torch, lambda: kck.launch(outs, program, **cops), 200)
    plain_ms = time_call(torch, lambda: kck.chain_kernel_plain(program, **cops), 3)
    b_ms, b_by = chain_bound(program, cops)
    print(f"timing chain_kernel live float-event block K={cops['K']} B={cops['block_size']} "
          f"on {card}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms "
          f"({b_by})")
    rows["chain_kernel"] = kernel_row(
        "chain_kernel", live_counts["cascade"]["chain_kernel"], 0.0, ms, plain_ms, b_ms,
        b_by, label="chain_kernel:live_cascade")
    rows["pink_noise"] = kernel_row("pink_noise", live_counts["ir"]["pink_noise"],
                                    *pink_noise_vs_plain(torch, np, dev, card),
                                    label="pink_noise:live_ir")
    return rows


# --------------------------------------------------------------------------
# the program and plan caches: recurring edits reuse renderers and lowered
# chain programs
# --------------------------------------------------------------------------

CACHE_BLOCKS = 64  # the FM cascade's render after a hit, in blocks
CACHE_CPU_BLOCKS = 16  # its first blocks held against the port's CPU render
CACHE_BANK_BLOCKS = 16  # a bank's render after a hit
CACHE_EDITS = 8  # the edit scenario's push/free edits


class LowerSpy:
    """``graph.chain_kernel.lower`` wrapped within ``with``: its calls and
    their host ms."""

    def __enter__(self):
        import knaster_tpu_torch.graph.chain_kernel as tck

        self.tck, self.real, self.ms = tck, tck.lower, []

        def spy(*a, **k):
            t0 = time.perf_counter()
            out = self.real(*a, **k)
            self.ms.append(1e3 * (time.perf_counter() - t0))
            return out

        tck.lower = spy
        return self

    def __exit__(self, *exc):
        self.tck.lower = self.real


def free_all(g):
    """Free every node of the top-level graph."""
    def edit(gg):
        for nid in list(gg.nodes):
            if nid in gg.nodes:
                gg.free_node(nid)

    g.edit(edit)


def cache_bank(ktt, np, kind, seed):
    """A bank node for the cache phase: the sine bank (table row 1) or the
    generic bank with the Envelope body (row 5), at N_VOICES, its voice
    defaults drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    vd = {"freq": rng.uniform(80, 3000, N_VOICES).astype(np.float32),
          "amp": np.full(N_VOICES, 5e-5, np.float32),
          "pan": rng.uniform(-1, 1, N_VOICES).astype(np.float32)}
    if kind == "sine":
        return ktt.FusedSineVoiceBank(N_VOICES, voice_defaults=vd)
    return ktt.FusedVoiceBank(ktt.EnvelopeVoice(), N_VOICES, voice_defaults=vd)


def cache_bank_render(torch, np, ktt, dev, kind, seeds):
    """Push a bank at each of ``seeds``' voice defaults in turn, freeing the
    one before; restart 64 voices and render CACHE_BANK_BLOCKS blocks after
    each push. Returns (the last render, its compile's hit, the processor)."""
    g, proc = ktt.AudioProcessor.new(0, 2, ktt.AudioProcessorOptions(block_size=BLOCK),
                                      device=dev)
    for seed in seeds:
        free_all(g)
        h = g.edit(lambda gg: gg.push(cache_bank(ktt, np, kind, seed)))
        g.edit(lambda gg: h.to_graph_out())
        for v in range(0, N_VOICES, N_VOICES // 64):
            h.voice_param("t_restart").trig(v)
        audio = proc.render(frames=CACHE_BANK_BLOCKS * BLOCK, fetch=False)
    return audio, proc.compiled.cache_hit, proc


def phase_program_cache(torch, np, ktt, dev, card):
    """The program and plan caches on the card (``graph/compile.py``):

    (a) the 256-stage FM cascade (the fm_cascade slice's graph, on the chain
    kernel, table row 6) pushed, freed and pushed again at other stage
    defaults (every SinWt at 1.5 x its freq): the second compile is a hit,
    ``lower`` is not called again, the chain kernel launches, and its
    CACHE_BLOCKS-block render is bit-equal to the same graph's compiled
    after ``clear_program_cache()``; its first CACHE_CPU_BLOCKS blocks
    against the port's CPU render within LIVE_FM_GATE (the cascade's FM
    feedback amplifies an ulp, as in phase_live).
    (b) a fused bank node (the sine bank, row 1; the generic bank with the
    Envelope body, row 5) pushed, freed and pushed at other voice defaults:
    a hit whose kernel launches, bit-equal to a fresh compile.
    (c) the soak's ``edit`` scenario as tools/time_live_chunks.py builds it
    (warmed for the stream's chunk), CACHE_EDITS push or free edits, each
    compiled and warmed by the async worker and swapped in, with no stream:
    per edit the host ms of the plan, the rest of the compile, ``lower``,
    the state carry and the warm, and whether it was a hit."""
    from knaster_tpu_torch.graph.compile import clear_program_cache

    rs = soak_module()
    # (a) the chain kernel
    t0 = time.perf_counter()
    opts = ktt.AudioProcessorOptions(block_size=BLOCK)
    faster = lambda f: ktt.SinWt(1.5 * f)  # noqa: E731
    with LowerSpy() as spy:
        g, proc = ktt.AudioProcessor.new(0, 1, opts, device=dev)
        g.edit(lambda gg: build_cascade(ktt, gg, CASCADE))
        proc.render(frames=4 * BLOCK, fetch=False)
        first = len(spy.ms)
        free_all(g)
        g.edit(lambda gg: build_cascade(ktt, gg, CASCADE, osc=faster))
        reset_all_counts()
        hit = proc.render(frames=CACHE_BLOCKS * BLOCK, fetch=False)
        launches = read_all_counts()["chain_kernel"]
        cg = proc.compiled
        if not cg.cache_hit or len(spy.ms) != first or first != 1 or not launches:
            fail(f"cache fm_cascade: hit {cg.cache_hit}, lower called {first} then "
                 f"{len(spy.ms) - first} times, {launches} chain kernel launches")
        clear_program_cache()
        g2, fresh_proc = ktt.AudioProcessor.new(0, 1, opts, device=dev)
        g2.edit(lambda gg: build_cascade(ktt, gg, CASCADE, osc=faster))
        fresh = fresh_proc.render(frames=CACHE_BLOCKS * BLOCK, fetch=False)
        if len(spy.ms) != first + 1:
            fail(f"cache fm_cascade: a fresh compile called lower {len(spy.ms) - first} "
                 "times")
    if not torch.equal(bits(hit), bits(fresh)):
        fail(f"cache fm_cascade: the hit's render differs from a fresh compile's by "
             f"{float((hit - fresh).abs().max())}")
    g3, cpu_proc = ktt.AudioProcessor.new(0, 1, opts, device="cpu")
    g3.edit(lambda gg: build_cascade(ktt, gg, CASCADE, osc=faster))
    cpu = cpu_proc.render(frames=CACHE_CPU_BLOCKS * BLOCK)
    head = hit[:, :CACHE_CPU_BLOCKS * BLOCK].cpu().numpy()
    peak = float(np.abs(head).max())
    err = float(np.abs(head - cpu).max())
    gate = LIVE_FM_GATE * max(1.0, peak)
    if not np.isfinite(head).all() or peak == 0.0 or err > gate:
        fail(f"cache fm_cascade: card vs CPU {err} (peak {peak}, gate {gate})")
    print(f"cache fm_cascade ({CASCADE} stages) on {card}: re-push at new defaults a "
          f"hit, lower {first} call ({spy.ms[0]:.2f} ms) and none on the hit, "
          f"{launches} chain kernel launches over {CACHE_BLOCKS} blocks bit-equal to a "
          f"fresh compile; card vs CPU {err:.3e} over {CACHE_CPU_BLOCKS} blocks (gate "
          f"{gate:.1e}); plan {cg.compile_ms['plan']:.1f} ms, build "
          f"{cg.compile_ms['build']:.1f} ms on the hit, plan "
          f"{fresh_proc.compiled.compile_ms['plan']:.1f} ms, build "
          f"{fresh_proc.compiled.compile_ms['build']:.1f} ms fresh "
          f"({time.perf_counter() - t0:.1f} s)")
    # (b) the fused banks
    for kind, kernel in (("sine", "sine_bank"), ("envelope", "generic_bank")):
        t0 = time.perf_counter()
        clear_program_cache()
        reset_all_counts()
        audio, was_hit, proc = cache_bank_render(torch, np, ktt, dev, kind, (1, 2))
        counts = read_all_counts()
        clear_program_cache()
        fresh, _, _ = cache_bank_render(torch, np, ktt, dev, kind, (2,))
        peak = float(audio.abs().max())
        if not was_hit or not counts[kernel] or peak == 0.0:
            fail(f"cache {kind} bank: hit {was_hit}, {counts[kernel]} {kernel} launches, "
                 f"peak {peak}")
        if not torch.equal(bits(audio), bits(fresh)):
            fail(f"cache {kind} bank: the hit's render differs from a fresh compile's by "
                 f"{float((audio - fresh).abs().max())}")
        print(f"cache {kind} bank (V={N_VOICES}) on {card}: re-push at new voice "
              f"defaults a hit, {counts[kernel]} {kernel} launches, "
              f"{CACHE_BANK_BLOCKS} blocks bit-equal to a fresh compile (peak "
              f"{peak:.4g}) ({time.perf_counter() - t0:.1f} s)")
    # (c) the edit scenario's edits, compiled and warmed as a stream's are
    t0 = time.perf_counter()
    clear_program_cache()
    rng = np.random.default_rng(0)
    g, proc = rs.processor(ktt, dev)
    hs = g.edit(lambda gg: rs.build(ktt, gg, "edit", rng))
    proc.warm_for_stream(LIVE_CHUNK)
    proc.enable_async_recompile()
    rows = []
    with LowerSpy() as spy:
        for i in range(CACHE_EDITS):
            if len(hs) > 66:
                victim = hs.pop(0)
                g.edit(lambda gg: victim.free())
                what = "free"
            else:
                def push_one(gg):
                    s = gg.push(ktt.SinWt(float(rng.uniform(150, 2000))))
                    (s * 0.002).to_graph_out()
                    return s

                hs.append(g.edit(push_one))
                what = "push"
            n_lower = len(spy.ms)
            proc._kick_async_compile()
            proc._compile_thread.join(timeout=120)
            proc._kick_async_compile()  # the swap
            c = proc.compiles[-1]
            if proc.compiled.revision != g.revision or c["revision"] != g.revision:
                fail(f"cache edit {i}: revision {g.revision} was not swapped in")
            c["lower_ms"] = sum(spy.ms[n_lower:])
            rows.append(c)
            proc.render(frames=LIVE_CHUNK * BLOCK, fetch=False)
            print(f"cache edit {i} ({what}, {len(hs)} sines) on {card}: hit {c['hit']}, "
                  f"plan {c['plan_ms']:.2f} ms, build {c['build_ms']:.2f} ms, lower "
                  f"{c['lower_ms']:.2f} ms, carry {c['carry_ms']:.2f} ms, warm "
                  f"{c['warm_ms']:.1f} ms")
    torch.cuda.synchronize()
    hits = [c for c in rows if c["hit"]]
    misses = [c for c in rows if not c["hit"]]
    if not hits:
        fail("cache edit: no edit was a program-cache hit")

    def med(cs, key):
        return float(np.median([c[key] for c in cs])) if cs else float("nan")

    print(f"cache edit on {card}: {len(hits)} of {len(rows)} edits hit; warm median "
          f"{med(misses, 'warm_ms'):.1f} ms on a miss, {med(hits, 'warm_ms'):.1f} ms on a "
          f"hit; plan+build median {med(misses, 'build_ms') + med(misses, 'plan_ms'):.2f} "
          f"ms on a miss, {med(hits, 'build_ms') + med(hits, 'plan_ms'):.2f} ms on a hit "
          f"({time.perf_counter() - t0:.1f} s)")


# --------------------------------------------------------------------------
# voices sharded over devices in one process (parallel/mesh.py)
# --------------------------------------------------------------------------

MESH_SHARDS = 4  # the multi-shard meshes: cuda:0 this many times on one card
MESH_BLOCKS = 64  # (a)'s blocks: every voice triggered in the first
MESH_FAMILY_VOICES = 16384  # (b)'s banks
MESH_FAMILY_BLOCKS = 16
MESH_EVENT_FREE = 4096  # (c)'s event-free render after the score, in samples
MESH_POOL_VOICES = 4096  # (d)
MESH_CHECKPOINT_BLOCKS = 32  # (e)'s resumed render


def mesh_gate(np, bank):
    """The stated gate of a mesh of N > 1 shards against the unsharded bank:
    the shards' partial mixes are summed in another order than the one
    kernel's tiers, an f32 rounding of the order of 1e-6 of the sum of the
    voices' amplitudes at most."""
    return 1e-6 * float(np.abs(bank.voice_defaults["amp"]).sum())


def mesh_run(torch, ktt, bank, ctx, dev, devices, events):
    """``bank`` over ``len(events)`` blocks (an event dict of the full
    bank's layout or None each), unsharded on ``dev`` when ``devices`` is
    None, else through a ShardedVoiceBank over them (the mix summed on the
    first of them).
    Returns (mix [C, n * B] on ``dev``, the full bank's final state on the
    CPU, host ms of the first block, host ms a block of the rest)."""
    if devices is None:
        state = bank.init(ctx, dev)

        def step(st, ev):
            return bank.process(ctx, st, events=ev)[:2]
    else:
        sb = ktt.ShardedVoiceBank(bank, ktt.make_mesh(devices), ctx)
        state = sb.init_state()
        step = sb.step
    outs, marks = [], []
    torch.cuda.synchronize()
    for ev in events:
        marks.append(time.perf_counter())
        state, out = step(state, ev)
        outs.append(out)
        if len(marks) == 1:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    if devices is not None:
        state = sb.node.join(ctx, state)
    else:
        state = {k: v.cpu() for k, v in state.items()}
    rest = (marks[-1] - marks[1]) / max(len(events) - 1, 1)
    return torch.cat(outs, dim=1), state, 1e3 * (marks[1] - marks[0]), 1e3 * rest


def mesh_compare(torch, np, ktt, bank, ctx, dev, events, label, card):
    """``bank`` unsharded, over one shard and over MESH_SHARDS shards on
    ``dev`` (and over every card where there are more): one shard bit-equal
    to the unsharded bank (mix and state), more shards within
    ``mesh_gate``. Prints each one's host ms a block."""
    meshes = [None, [dev], [dev] * MESH_SHARDS]
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        meshes.append([torch.device("cuda", i) for i in range(n_cards)])
    # the first eventful block of a process loads the staging ops' modules:
    # out of the timed runs
    mesh_run(torch, ktt, bank, ctx, dev, None, events[:2])
    runs = [mesh_run(torch, ktt, bank, ctx, dev, d, events) for d in meshes]
    ref, ref_state = runs[0][0], runs[0][1]
    peak = float(ref.abs().max())
    if not bool(torch.isfinite(ref).all()) or peak == 0.0:
        fail(f"mesh {label}: the unsharded render is not finite or silent")
    gate = mesh_gate(np, bank)
    parts = [f"unsharded {runs[0][3]:.3f} ms a block (first {runs[0][2]:.1f} ms)"]
    for d, (mix, state, first_ms, ms) in zip(meshes[1:], runs[1:]):
        n = len(d)
        if n == 1:
            same = torch.equal(bits(mix), bits(ref)) and all(
                torch.equal(bits(state[k]), bits(ref_state[k])) for k in ref_state)
            if not same:
                fail(f"mesh {label}: one shard is not bit-equal to the unsharded bank "
                     f"(mix differs by {float((mix - ref).abs().max())})")
            parts.append(f"N=1 {ms:.3f} ms (bit-equal)")
            continue
        err = float((mix - ref).abs().max())
        if err > gate:
            fail(f"mesh {label}: {n} shards differ from the unsharded bank by {err} "
                 f"(gate {gate})")
        # a voice's state is its own: only the mix's summation order moves
        for k in ref_state:
            if not torch.equal(bits(state[k]), bits(ref_state[k])):
                fail(f"mesh {label}: {n} shards' {k} differs from the unsharded bank's")
        where = "cards" if len(set(d)) > 1 else str(dev)
        parts.append(f"N={n} on {where} {ms:.3f} ms (first {first_ms:.1f} ms), "
                     f"max |err| {err:.3e} (gate {gate:.3e})")
    print(f"mesh {label} (V={bank.n_voices}, {len(events)} blocks of {BLOCK}) on {card}: "
          + "; ".join(parts) + f"; peak {peak:.4g}")
    return runs


def mesh_cluster(torch, ktt, dev, devices, score=True):
    """tools/mesh_voice_cluster.py's graph with the fused sine bank, sharded
    over ``devices`` or (None) unsharded, on ``dev``: (processor, bank
    handle, the example's score and second of tail rendered, or None
    without ``score``)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import mesh_voice_cluster as mvc

    V = mvc.VOICES_PER_DEVICE * MESH_SHARDS
    bank, detune = mvc.make_bank(ktt, V, fused=True)
    node = bank if devices is None else ktt.MeshVoiceBank(bank, ktt.make_mesh(devices))
    if not score:
        g, proc = ktt.AudioProcessor.new(0, 2, ktt.AudioProcessorOptions(
            block_size=mvc.BLOCK, sample_rate=mvc.SR), device=dev)
        h, _ = g.edit(lambda gg: mvc.build(ktt, gg, node))
        return proc, h, None
    _, proc, h, _, seconds = mvc.cluster(ktt, node, detune, device=dev)
    return proc, h, proc.render(frames=int((seconds + 1.0) * SR), fetch=False)


def phase_mesh(torch, np, ktt, dev, card):
    """Voices sharded over devices in one process (``parallel/mesh.py``),
    on one card the same device MESH_SHARDS times:

    (a) the headline sine bank (table row 1) at N_VOICES, every voice
    restarted in the first of MESH_BLOCKS blocks: one shard bit-equal to
    the unsharded bank, MESH_SHARDS within ``mesh_gate``, host ms a block
    of each; (b) the wavetable bank (row 4) and the Envelope body's
    generic bank (row 5) at MESH_FAMILY_VOICES over ``schedule`` and
    event-free blocks, the same way; (c) tools/mesh_voice_cluster.py with
    the fused sine bank over MESH_SHARDS shards against the same graph with
    the bank unsharded (the example's four chords), then MESH_EVENT_FREE
    event-free samples, the block lengths the local bank was handed
    (none past its MAX_BLOCK); (d) a VoicePool over a MeshVoiceBank of the
    Envelope body: every voice released once its program ran out; (e) the
    cluster graph saved and loaded into a fresh processor: each shard's
    leaves back on its device and the resumed render bit-equal. The phase's
    kernel launches are counted; each kernel of the path must launch."""
    import tempfile

    from knaster_tpu_torch.kernels.bank_common import MAX_BLOCK

    ctx = ktt.AudioCtx(SR, BLOCK, torch.float32)
    reset_counts()
    # (a) the headline bank
    bank = make_bank(ktt, np, "sine", N_VOICES, N_VOICES)
    tr = bank.trig_index("t_restart")
    first = bank.node_events_from_lists([(v % BLOCK, v, tr, 1, 0.0) for v in range(N_VOICES)])
    mesh_compare(torch, np, ktt, bank, ctx, dev, [first] + [None] * (MESH_BLOCKS - 1),
                 "sine", card)
    # (b) the wavetable bank and the Envelope body
    V = MESH_FAMILY_VOICES
    for label, fam in (("wt", make_bank(ktt, np, "wt", V, V)),
                       ("envelope", envelope_bank(ktt, np, V, V, looping=False))):
        events = [None if e is None else fam.node_events_from_lists(e)
                  for e in schedule(fam, V, BLOCK)]
        events += [None] * (MESH_FAMILY_BLOCKS - len(events))
        mesh_compare(torch, np, ktt, fam, ctx, dev, events, label, card)
    # (c) the cluster example on the card
    proc, h, mesh_audio = mesh_cluster(torch, ktt, dev, [dev] * MESH_SHARDS)
    _, _, plain_audio = mesh_cluster(torch, ktt, dev, None)
    node = proc.graph._node(h.node_id).ugen
    err = float((mesh_audio - plain_audio).abs().max())
    peak = float(plain_audio.abs().max())
    gate = mesh_gate(np, node.bank)
    if not bool(torch.isfinite(mesh_audio).all()) or peak == 0.0 or err > gate:
        fail(f"mesh cluster: {MESH_SHARDS} shards vs unsharded {err} (gate {gate}, "
             f"peak {peak})")
    seen = []
    process = node._local.process

    def spy(c, *a, **k):
        seen.append(c.block_size)
        return process(c, *a, **k)

    node._local.process = spy
    tail = proc.render(frames=MESH_EVENT_FREE, fetch=False)
    node._local.process = process
    torch.cuda.synchronize()
    if not seen or max(seen) > MAX_BLOCK or sum(seen) != MESH_EVENT_FREE * MESH_SHARDS:
        fail(f"mesh cluster: the local bank was handed blocks {seen}")
    print(f"mesh cluster (tools/mesh_voice_cluster.py --fused, {node.n_voices} voices, "
          f"{MESH_SHARDS} shards) on {card}: {mesh_audio.shape[1] / SR:g} s against the "
          f"unsharded bank {err:.3e} (gate {gate:.3e}, peak {peak:.4g}); then "
          f"{MESH_EVENT_FREE} event-free samples, the local bank handed blocks of "
          f"{seen[::MESH_SHARDS]} samples on each shard (tail peak "
          f"{float(tail.abs().max()):.4g})")
    # (e) the cluster graph's checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.ckpt")
        proc.save_state(path)
        fresh, fh, _ = mesh_cluster(torch, ktt, dev, [dev] * MESH_SHARDS, score=False)
        fresh.load_state(path)
    fnode = fresh.graph._node(fh.node_id).ugen
    shards = fnode.shards(fresh.state["nodes"][fresh.compiled._node_loc(fh.node_id)[1]])
    for s, d in zip(shards, fnode.mesh.devices):
        if any(x.device != d for x in s.values()):
            fail(f"mesh checkpoint: a shard's leaf was not restored onto {d}")
    n = MESH_CHECKPOINT_BLOCKS * BLOCK
    a, b = proc.render(frames=n, fetch=False), fresh.render(frames=n, fetch=False)
    if not torch.equal(bits(a), bits(b)):
        fail(f"mesh checkpoint: the resumed render differs by {float((a - b).abs().max())}")
    print(f"mesh checkpoint on {card}: {len(shards)} shards restored onto their devices, "
          f"{MESH_CHECKPOINT_BLOCKS} blocks bit-equal after load_state")
    # (d) VoicePool over the Envelope body's mesh bank
    g, pproc = ktt.AudioProcessor.new(0, 2, ktt.AudioProcessorOptions(block_size=BLOCK),
                                      device=dev)
    fam = envelope_bank(ktt, np, MESH_POOL_VOICES, 4 * MESH_POOL_VOICES, looping=False)
    ph = g.edit(lambda gg: gg.push(ktt.MeshVoiceBank(fam, ktt.make_mesh([dev] * MESH_SHARDS))))
    ph.to_graph_out()
    g.commit()
    pool = ktt.VoicePool(pproc, ph)
    pproc.render(frames=BLOCK, fetch=False)
    if any(pool.note_on({"freq": 300.0 + v % 500}) is None for v in range(MESH_POOL_VOICES)):
        fail("mesh pool: the pool ran out of voices")
    sounding = pproc.render(frames=2 * BLOCK, fetch=False)
    held = pool.held_count
    pproc.render(frames=8 * BLOCK, fetch=False)  # the 2.6 ms program is long over
    released = pool.refresh()
    if (held != MESH_POOL_VOICES or released != MESH_POOL_VOICES
            or pool.free_count != pool.n_voices or float(sounding.abs().max()) == 0.0):
        fail(f"mesh pool: {held} held, refresh released {released}, {pool.free_count} free "
             f"of {pool.n_voices}")
    print(f"mesh pool on {card}: {MESH_POOL_VOICES} Envelope voices over {MESH_SHARDS} "
          f"shards, every one released by refresh() once its program ran out")
    counts = read_counts()
    for name in ("sine_bank", "wt_bank", "generic_bank"):
        if not counts[name]:
            fail(f"mesh: {name} never launched in the phase")
    print(f"mesh launches: {counts}")


# --------------------------------------------------------------------------
# the user's side: user voices' CUDA bodies in the generic harness, the
# custom-voice example, and a graph of the user-written UGens
# --------------------------------------------------------------------------

ORGAN_SECONDS = 2.5  # examples/custom_voice_bank.py's 10 s, cut
# held against the port's CPU render (~36 s of host a rendered second, so
# not the whole 2.5 s): the same bank and score with its chords
# ORGAN_CMP_SPACING apart (mid-block at B = 64), rendered for
# ORGAN_CMP_SECONDS on both: the first chord and three retune-and-restart
# blocks; the timed render's first chord against the same CPU render
ORGAN_CMP_SECONDS = 0.3
ORGAN_CMP_SPACING = 0.075
EXT_SECONDS = 0.5  # the extension graph's render, on the card and on the CPU
EXT_COUNT_SECONDS = 0.064  # its launches counted over 48 blocks (the profiler's events cost)
EXT_GATE = 1e-6  # card vs CPU, x max(1, peak)


def user_voices_module():
    """tools/user_voices.py: the user voices' torch and CUDA bodies."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import user_voices

    return user_voices


def organ_processor(ktt, uv, dev, seconds, spacing=None, torch_only=False):
    """examples/custom_voice_bank.py on the port: 512 OrganVoices (with the
    hand CUDA body, or ``torch_only``: the lowered torch body) with the
    example's defaults in a FusedVoiceBank graph node, its four chords
    ``spacing`` apart (by default spread over ``ORGAN_SECONDS``),
    scheduled for ``seconds``."""
    g, proc = ktt.knaster(outputs=2, device=dev)
    voice = uv.torch_only(uv.OrganVoice()) if torch_only else uv.OrganVoice()
    bank = g.edit(lambda gg: gg.push(ktt.FusedVoiceBank(
        voice, uv.ORGAN_VOICES,
        voice_defaults=uv.organ_defaults(), event_capacity=SUITE_CAPACITY)))
    bank.to_graph_out()
    g.commit()
    uv.organ_score(bank, seconds, spacing or ORGAN_SECONDS / len(uv.ORGAN_CHORDS))
    proc._ensure_compiled()
    return proc


def extension_graph(kt, g, seconds=EXT_SECONDS):
    """A graph of the user's side: ``OscWt(Wavetable.saw(), interpolate=True)``
    gliding 20 Hz -> 20 kHz over ``seconds`` (every one of the 17 tables)
    with a ``reset_phase`` trigger, ``.wr_mul(0.5)`` into ``SafetyLimiter``
    into an ``@ugen`` block gain; an ``@ugen.sample`` saw with a reset
    trigger into ``ugen_from_sample_fn`` (its square); a ``SinWt`` under
    ``WrArParamToInput(..., "freq")`` driven by a ``Phasor``; and a
    subgraph whose ``DoneOnTrig`` frees it (``Done.FREE_PARENT``) at 60% of
    the render. All into one output."""
    import torch

    from knaster_tpu_torch.wrappers import WrArParamToInput

    @kt.ugen(inputs=1, outputs=1)
    def block_gain(inputs, *, amount=0.8):
        return inputs * amount[None, :]

    @kt.ugen.sample(inputs=0, outputs=1,
                    state=lambda ctx: {"phase": torch.zeros((), dtype=ctx.dtype)})
    def saw(carry, frame, *, freq=110.0, t_reset=kt.TRIG):
        phase = torch.where(t_reset, torch.zeros_like(carry["phase"]), carry["phase"])
        step = phase + freq * (1.0 / SR)
        return {"phase": step - torch.floor(step)}, (phase * 2.0 - 1.0).reshape(1)

    def at(frac):
        return kt.Seconds.from_samples(int(frac * seconds * SR), SR)

    def build(gg):
        osc = gg.push(kt.OscWt(kt.Wavetable.saw(), 20.0, interpolate=True).wr_mul(0.5))
        lim = gg.push(kt.SafetyLimiter())
        gain = gg.push(block_gain())
        osc.to(lim)
        lim.to(gain)
        gain.to_graph_out()
        sw = gg.push(saw(freq=110.0))
        sq = gg.push(kt.ugen_from_sample_fn(lambda f: f * f * 0.25, inputs=1, outputs=1))
        sw.to(sq)
        sq.to_graph_out()
        lfo = gg.push(kt.Phasor(3.0))
        ar = gg.push(WrArParamToInput(kt.SinWt(0.0), "freq"))
        (lfo * 300.0 + 200.0).to(ar)
        (ar * 0.2).to_graph_out()
        child, ch = gg.subgraph(inputs=0, outputs=1, name="voice")
        tone = child.push(kt.SinWt(660.0))
        (tone * 0.1).to_graph_out()
        done = child.push_with_done_action(kt.DoneOnTrig(), kt.Done.FREE_PARENT)
        ch.to_graph_out()
        return osc, sw, done, ch

    osc, sw, done, ch = g.edit(build)
    freq = osc.param("freq")
    freq.smooth(kt.Smoothing.linear(seconds))
    freq.set(20000.0)
    osc.param("reset_phase").trig_at(at(0.37))
    sw.param("t_reset").trig_at(at(0.21))
    done.param("t_done").trig_at(at(0.6))
    return ch


def phase_extensions(torch, np, ktt, dev, card):
    """The user's side of the library on the card. (1) The user voices'
    CUDA bodies (tools/user_voices.py: ``DetunedVoice``, mono;
    ``OrganVoice``, stereo with the exact pan) in the generic harness,
    each against its torch body at V in {1000, 131072}, B = 64, eventful
    and event-free (``phase_kernel_vs_plain``): carry bit-equal, mix
    within the gate; the detuned bank's slice through ``bank.process`` at
    131,072 voices (``phase_slice``), and each body's kernel ms
    (``phase_timings``). (2) examples/custom_voice_bank.py: 512
    OrganVoices with its defaults and four retuned chords through
    ``AudioProcessor.render``, ORGAN_SECONDS on the card (realtime x,
    launches); the same score with its chords ORGAN_CMP_SPACING apart,
    ORGAN_CMP_SECONDS on the card and on the CPU, and the timed render's
    first chord against it, within 1e-6 x max(1, peak). (3) ``extension_graph`` on the card and
    the CPU within EXT_GATE x max(1, peak): realtime x and kernel launches
    per rendered second. Returns the kernels line's rows of the two user
    bodies and the organ score's CPU render (``phase_lowered`` holds the
    lowered organ against it)."""
    from knaster_tpu_torch.kernels import build
    from knaster_tpu_torch.kernels import generic_bank as gk

    uv = user_voices_module()
    t0 = time.perf_counter()
    errs = {name: phase_kernel_vs_plain(torch, np, ktt, dev, f"generic-user-{name}",
                                        Bs=(BLOCK,))
            for name in ("detuned", "organ")}
    for name, src in (("detuned", uv.DETUNED_SOURCE), ("organ", uv.ORGAN_SOURCE)):
        print(f"  user body {name}: {build.user_body_path(src).name}")

    ctx = ktt.AudioCtx(SR, BLOCK, torch.float32)
    bank, state, det_launches, _, _, _ = phase_slice(torch, np, ktt, dev,
                                                     "generic-user-detuned", card, False)
    operands, _ = bank.kernel_operands(ctx, state, None)
    _, err, _ = compare_block(torch, "generic", bank, operands, "slice user detuned final block")
    errs["detuned"] = max(errs["detuned"], err)
    det_row = phase_timings(torch, ktt, "generic-user-detuned", bank, sounding_state(
        torch, ktt, bank), card)
    print(f"  (user bodies: {time.perf_counter() - t0:.1f} s)")

    # (2) the custom-voice example
    t0 = time.perf_counter()
    proc = organ_processor(ktt, uv, dev, ORGAN_SECONDS)
    reset_all_counts()
    audio, secs = render_timed(torch, proc, ORGAN_SECONDS)
    counts = read_all_counts()
    organ_launches = counts[gk.KERNEL]
    if organ_launches == 0:
        fail("custom_voice_bank: the generic kernel never launched")
    expect_counts(counts, {gk.KERNEL: organ_launches}, "custom_voice_bank")
    a = audio.cpu().numpy()
    c, b = (np.asarray(organ_processor(ktt, uv, d, ORGAN_CMP_SECONDS, ORGAN_CMP_SPACING)
                       .render(seconds=ORGAN_CMP_SECONDS)) for d in (dev, "cpu"))
    b_organ = b
    n_head = int(ORGAN_CMP_SPACING * SR)
    gap, peak = float(np.abs(c - b).max()), float(np.abs(b).max())
    head_gap = float(np.abs(a[:, :n_head] - b[:, :n_head]).max())
    if (not np.isfinite(a).all() or not np.isfinite(c).all() or peak < 1e-3
            or max(gap, head_gap) > 1e-6 * max(1.0, peak)):
        fail(f"custom_voice_bank: card vs CPU differ by {gap} over the chords "
             f"{ORGAN_CMP_SPACING:g} s apart, the timed render's first chord by "
             f"{head_gap} (peak {peak}), or silent")
    tail_peak = float(np.abs(a[:, -SR // 4:]).max())
    if tail_peak < 1e-3:
        fail(f"custom_voice_bank: the last chord is silent ({tail_peak})")
    print(f"slice custom_voice_bank: {uv.ORGAN_VOICES} OrganVoices, {ORGAN_SECONDS:g} s on {card} "
          f"in {secs:.3f} s (realtime x {ORGAN_SECONDS / secs:.4g}), generic_bank launches "
          f"{organ_launches}; card vs CPU over {ORGAN_CMP_SECONDS:g} s of its four chords "
          f"{ORGAN_CMP_SPACING:g} s apart {gap:.3e}, the timed render's first chord "
          f"{head_gap:.3e}, peak {peak:.4g}")
    obank = make_bank(ktt, np, "generic-user-organ", N_VOICES, SUITE_CAPACITY)
    organ_row = phase_timings(torch, ktt, "generic-user-organ", obank,
                              sounding_state(torch, ktt, obank), card)
    print(f"  (custom_voice_bank and the organ body's timing: {time.perf_counter() - t0:.1f} s)")

    # (3) the extension graph
    t0 = time.perf_counter()
    got = {}
    for d in (dev, "cpu"):
        g, p = ktt.AudioProcessor.new(0, 1, ktt.AudioProcessorOptions(block_size=BLOCK),
                                      dtype=torch.float32, device=d)
        ch = extension_graph(ktt, g)
        p._ensure_compiled()
        t1 = time.perf_counter()
        out = np.asarray(p.render(seconds=EXT_SECONDS))
        got[str(d)] = (out, time.perf_counter() - t1, ch.node_id in g.nodes)
    (a, secs, alive), (b, _, cpu_alive) = got[str(dev)], got["cpu"]
    gap, peak = float(np.abs(a - b).max()), float(np.abs(b).max())
    if not np.isfinite(a).all() or peak < 1e-3 or gap > EXT_GATE * max(1.0, peak):
        fail(f"extension graph: card vs CPU differ by {gap} (peak {peak}), or silent")
    if alive or cpu_alive:
        fail("extension graph: DoneOnTrig did not free its subgraph")
    g, p = ktt.AudioProcessor.new(0, 1, ktt.AudioProcessorOptions(block_size=BLOCK),
                                  dtype=torch.float32, device=dev)
    extension_graph(ktt, g)
    p._ensure_compiled()
    n = count_kernels(torch, lambda: p.render(seconds=EXT_COUNT_SECONDS, fetch=False))
    per_s = "not measured" if n is None else f"{n / EXT_COUNT_SECONDS:.6g}"
    print(f"slice extension graph: {EXT_SECONDS:g} s on {card} in {secs:.3f} s (realtime x "
          f"{EXT_SECONDS / secs:.4g}), {per_s} kernel launches per rendered second (over its "
          f"first {EXT_COUNT_SECONDS:g} s); card vs CPU {gap:.3e}, peak {peak:.4g}; subgraph "
          f"freed by DoneOnTrig ({time.perf_counter() - t0:.1f} s)")

    rows = []
    for name, launches, row in (("detuned", det_launches, det_row),
                                ("organ", organ_launches, organ_row)):
        r = kernel_row("generic_bank", launches, errs[name], *row,
                       label=f"generic_bank:user-{name}")
        r["source"] = "tools/user_voices.py"
        rows.append(r)
    return rows, b_organ


# --------------------------------------------------------------------------
# voices whose torch bodies the card runs lowered to CUDA (kernels/lower.py)
# --------------------------------------------------------------------------

# kind -> the bank's voices in its slice and timing: the user voices at the
# suite's bank size, the Modal bodies at modal_bank's (suite.py:962-1023)
LOWERED = {"lowered-detuned": N_VOICES, "lowered-organ": N_VOICES,
           "lowered-modal12": MODAL_VOICES, "lowered-modal17": MODAL_VOICES,
           "lowered-modal32": MODAL_VOICES, "lowered-modal64": MODAL_VOICES}
# the hand-written or library body each lowered one stands in for, timed
# beside it on the same operands
LOWERED_YARDSTICK = {"lowered-detuned": "generic-user-detuned",
                     "lowered-organ": "generic-user-organ", "lowered-modal12": "modal12"}
LOWERED_SLICE_BLOCKS = 64  # event-free blocks of a lowered bank's slice, after its trigger block
# (V, body_schedule's blocks) each lowered Modal body is held against its
# torch body over: all four at V = 1000 (four CTAs, the last ragged); the
# full size's first two were cut with the examples, for the time limit (the
# plain 64-mode body takes ~4 s a block on the card there; the lowered bell
# stays held against the library body at 65,536 voices)
LOWERED_MODAL_CHECKS = ((1000, 4),)
# the hand count of operations a voice-sample of the function each lowered
# user body computes (OPS_PER_SAMPLE's key); the Modal bodies' is modal_ops
LOWERED_FUNCTION_OPS = {"lowered-detuned": "generic-user-detuned",
                        "lowered-organ": "generic-user-organ"}


def lowered_body(torch, ktt, bank):
    """The bank's voice's torch body lowered (``generic_bank.lowered``,
    kept on its spec)."""
    from knaster_tpu_torch.kernels import generic_bank as gk

    spec = bank.spec(ktt.AudioCtx(SR, BLOCK, torch.float32))
    return gk.lowered(spec, bank._float_names, bank._trig_names, bank.voice.outputs)


def lowered_sources(torch, np, ktt):
    """{kind: LoweredBody} of every ``LOWERED`` voice: what the build phase
    compiles."""
    return {kind: lowered_body(torch, ktt, make_bank(ktt, np, f"generic-{kind}", 32, 32))
            for kind in LOWERED}


def yardstick_bank(ktt, np, kind, V, capacity, seed=0):
    """The bank of the hand or library body that lowered ``kind`` stands in
    for, on the same defaults (the same state layout and constants)."""
    other = LOWERED_YARDSTICK[kind]
    if other == "modal12":
        return modal_bank(ktt, np, V, capacity, "bell", seed)
    return make_bank(ktt, np, other, V, capacity, seed)


def lowered_schedule(bank, V, B):
    return (body_schedule if "t_strike" in bank._trig_names else schedule)(bank, V, B)


def lowered_slice(torch, np, ktt, dev, kind, card):
    """A lowered bank through ``bank.process`` at its ``LOWERED`` size: one
    block of SUITE_CAPACITY restarts or strikes (spread over the bank), then
    LOWERED_SLICE_BLOCKS event-free blocks; every block launches the generic
    kernel, the mix is finite and sounds. Returns (bank, state, launches)."""
    from knaster_tpu_torch.kernels import generic_bank as gk

    V = LOWERED[kind]
    ctx = ktt.AudioCtx(SR, BLOCK, torch.float32)
    bank = make_bank(ktt, np, f"generic-{kind}", V, SUITE_CAPACITY)
    trig = bank.trig_index("t_strike" if "t_strike" in bank._trig_names else "t_restart")
    ev = bank.node_events_from_lists([(0, v, trig, 1, 0.0)
                                      for v in range(0, V, V // SUITE_CAPACITY)])
    state = bank.init(ctx, device=dev)
    torch.cuda.synchronize()
    reset_all_counts()
    state, _ = bank.process(ctx, state, events=ev)
    state, outs, secs = timed_blocks(torch, bank, ctx, state, LOWERED_SLICE_BLOCKS)
    counts = read_all_counts()
    expect_counts(counts, {gk.KERNEL: 1 + LOWERED_SLICE_BLOCKS}, f"slice {kind}")
    peak = float(outs.abs().max())
    if not bool(torch.isfinite(outs).all()) or peak == 0.0:
        fail(f"slice {kind}: the rendered mix is not finite or silent")
    print(f"slice {kind}: {V} voices, {SUITE_CAPACITY} triggers in block 0, "
          f"{LOWERED_SLICE_BLOCKS} event-free blocks in {secs:.4f} s "
          f"({V * LOWERED_SLICE_BLOCKS * BLOCK / secs:.6g} voice-samples/s on {card}), "
          f"mix peak {peak:.4g}, generic_bank launches {counts[gk.KERNEL]}")
    return bank, state, counts[gk.KERNEL]


def lowered_timings(torch, np, ktt, kind, bank, state, card):
    """The lowered body's kernel ms (device time in a CUDA graph), event-free
    from ``state`` and eventful, beside its yardstick's on the same operands
    where it has one; the plain version's ms; the bound from the bytes or
    from the operations a voice-sample that the voice's function needs on
    this state: the hand count of the body it stands in for (the organ's
    with its pan taken once a block where the pan is flat,
    ``user_ops_per_sample``), ``modal_ops`` for the Modal bodies. The
    lowering's own count (``LoweredBody.ops_per_sample``, which also counts
    work the function takes once a block, such as a flat pan) is printed
    beside it. Returns (ms, plain_ms, bound_ms, bound_by)."""
    from knaster_tpu_torch.kernels import generic_bank as gk

    ctx = ktt.AudioCtx(SR, BLOCK, torch.float32)
    V = bank.n_voices
    ops, _ = bank.kernel_operands(ctx, state, None)
    ev = bank.node_events_from_lists(lowered_schedule(bank, V, BLOCK)[0][:bank.event_capacity])
    ev_ops, _ = bank.kernel_operands(ctx, state, ev)
    outs = gk.empty_outputs(ops["carry"], bank.voice.outputs, BLOCK)
    ms = time_graph(torch, lambda: gk.launch(outs, **ops), 100)
    ev_ms = time_graph(torch, lambda: gk.launch(outs, **ev_ops), 50)
    line = f"event-free kernel {ms:.4f} ms, eventful {ev_ms:.4f} ms"
    if kind in LOWERED_YARDSTICK:
        other = yardstick_bank(ktt, np, kind, V, bank.event_capacity).spec(ctx)
        o_ms = time_graph(torch, lambda: gk.launch(outs, **dict(ops, spec=other)), 100)
        o_ev = time_graph(torch, lambda: gk.launch(outs, **dict(ev_ops, spec=other)), 50)
        line += (f"; {LOWERED_YARDSTICK[kind]} on the same operands {o_ms:.4f} ms, "
                 f"eventful {o_ev:.4f} ms (lowered / yardstick {ms / o_ms:.3f}, {ev_ms / o_ev:.3f})")
    plain_ms = time_call(torch, lambda: gk.generic_bank_plain(**ops), 1)
    fn = LOWERED_FUNCTION_OPS.get(kind)
    if fn in USER_FLAT_PAN_OPS_PER_SAMPLE:
        per_sample, _ = user_ops_per_sample(torch, fn, ops, BLOCK)
    elif fn is not None:
        per_sample = OPS_PER_SAMPLE[fn]
    else:
        per_sample = modal_ops(bank.voice.res.n_modes, moving_pans(torch, bank, ops, BLOCK))
    nbytes = tensor_bytes(ops, written(gk, outs))
    bound_ms, bound_by = bound(nbytes, per_sample * V * BLOCK)
    lowering = lowered_body(torch, ktt, bank).ops_per_sample
    at_lowering, _ = bound(nbytes, lowering * V * BLOCK)
    print(f"timing generic_bank:{kind} V={V} B={BLOCK} on {card}: {line}; plain "
          f"{plain_ms:.3f} ms; bound {bound_ms:.5f} ms ({bound_by}, {per_sample:g} f32 "
          f"operations a voice-sample that the function needs); at the lowering's count "
          f"({lowering} operations a voice-sample) {at_lowering:.5f} ms")
    return ms, plain_ms, bound_ms, bound_by


def phase_lowered(torch, np, ktt, dev, card, organ_cpu):
    """Voices that reach the card from their torch bodies alone
    (kernels/lower.py, built in the build phase). (1) Each lowered body in
    the generic harness against its torch body on the card: the torch-only
    ``DetunedVoice`` and ``OrganVoice`` at V in {1000, 131072}, B = 64,
    over ``schedule``'s five blocks, eventful and event-free
    (``phase_kernel_vs_plain``); the bell (M = 12, its library body
    dropped) and strings of 17, 32 and 64 modes over ``body_schedule``'s
    blocks as LOWERED_MODAL_CHECKS says (all four at V = 1000): carry
    bit-equal, mix within the gate.
    (2) The lowered bell's carry bit-equal to the library ``modal12``
    body's, block by block from one state and schedule at 65,536 voices.
    (3) Each lowered bank's slice (``lowered_slice``: its launches), and
    the kernels one event-free block of the 64-mode bank takes (its
    ``idle_of`` stays eager torch). (4) examples/custom_voice_bank.py's score
    through the torch-only organ: ORGAN_SECONDS on the card (realtime x,
    launches) and the chords ORGAN_CMP_SPACING apart against the CPU
    render ``organ_cpu`` within 1e-6 x max(1, peak). (5) Each lowered
    body's timing (``lowered_timings``). Returns the kernels line's rows."""
    from knaster_tpu_torch.kernels import generic_bank as gk

    uv = user_voices_module()
    ctx = ktt.AudioCtx(SR, BLOCK, torch.float32)
    t0 = time.perf_counter()
    errs = {}
    for kind in ("lowered-detuned", "lowered-organ"):
        errs[kind] = phase_kernel_vs_plain(torch, np, ktt, dev, f"generic-{kind}", Bs=(BLOCK,))
    for kind in ("lowered-modal12", "lowered-modal17", "lowered-modal32", "lowered-modal64"):
        t1 = time.perf_counter()
        errs[kind] = 0.0
        for V, n in LOWERED_MODAL_CHECKS:
            bank = make_bank(ktt, np, f"generic-{kind}", V, V * 2, seed=V)
            e, _, _, _ = run_generic_vs_plain(
                torch, ktt, bank, dev, BLOCK, body_schedule(bank, V, BLOCK)[:n], f"{kind} V={V}")
            errs[kind] = max(errs[kind], e)
        over = ", ".join(f"{n} blocks at V={V}" for V, n in LOWERED_MODAL_CHECKS)
        print(f"kernel vs plain {kind} B={BLOCK}: carries bit-equal over {over} (eventful and "
              f"event-free), max |mix diff| {errs[kind]:.3e} ({time.perf_counter() - t1:.1f} s)")

    # (2) the lowered bell against the library modal12 body
    V = MODAL_VOICES
    banks = (yardstick_bank(ktt, np, "lowered-modal12", V, V, seed=3),
             make_bank(ktt, np, "generic-lowered-modal12", V, V, seed=3))
    states = [b.init(ctx, device=dev) for b in banks]
    gap = 0.0
    for blk, evs in enumerate(body_schedule(banks[0], V, BLOCK)):
        outs = []
        for i, b in enumerate(banks):
            operands, carry = b.kernel_operands(
                ctx, states[i], None if evs is None else b.node_events_from_lists(evs))
            k = b.kernel(**operands)
            states[i], _ = b.finish(ctx, carry, k)
            outs.append(k)
        torch.cuda.synchronize()
        if not torch.equal(outs[0][1], outs[1][1]):
            fail(f"lowered modal12 block {blk}: carry differs from the library modal12 body's "
                 f"in {int((outs[0][1] != outs[1][1]).sum())} words")
        gap = max(gap, float((outs[0][0] - outs[1][0]).abs().max()))
        if gap > mix_tolerance(V, float(outs[0][0].abs().max())):
            fail(f"lowered modal12 block {blk}: mix differs from the library body's by {gap}")
    print(f"lowered modal12 vs library modal12 V={V}: carries bit-equal over 4 blocks, max "
          f"|mix diff| {gap:.3e}")
    print(f"  (lowered bodies vs plain: {time.perf_counter() - t0:.1f} s)")

    # (3) the slices
    t0 = time.perf_counter()
    slices = {kind: lowered_slice(torch, np, ktt, dev, kind, card)
              for kind in LOWERED if kind != "lowered-organ"}
    bank, state, _ = slices["lowered-modal64"]
    n = count_kernels(torch, lambda: bank.process(ctx, state))
    print(f"slice lowered-modal64: {n if n is not None else 'not measured'} kernels in one "
          f"event-free block (the lowered body once; the rest staging and the eager idle_of)")

    # (4) the custom-voice example through the lowered organ
    proc = organ_processor(ktt, uv, dev, ORGAN_SECONDS, torch_only=True)
    reset_all_counts()
    audio, secs = render_timed(torch, proc, ORGAN_SECONDS)
    counts = read_all_counts()
    organ_launches = counts[gk.KERNEL]
    if organ_launches == 0:
        fail("custom_voice_bank (lowered organ): the generic kernel never launched")
    expect_counts(counts, {gk.KERNEL: organ_launches}, "custom_voice_bank (lowered organ)")
    a = audio.cpu().numpy()
    c = np.asarray(organ_processor(ktt, uv, dev, ORGAN_CMP_SECONDS, ORGAN_CMP_SPACING,
                                   torch_only=True).render(seconds=ORGAN_CMP_SECONDS))
    n_head = int(ORGAN_CMP_SPACING * SR)
    gap, peak = float(np.abs(c - organ_cpu).max()), float(np.abs(organ_cpu).max())
    head_gap = float(np.abs(a[:, :n_head] - organ_cpu[:, :n_head]).max())
    if (not np.isfinite(a).all() or not np.isfinite(c).all() or peak < 1e-3
            or max(gap, head_gap) > 1e-6 * max(1.0, peak)):
        fail(f"custom_voice_bank (lowered organ): card vs CPU differ by {gap} over the chords, "
             f"the timed render's first chord by {head_gap} (peak {peak}), or silent")
    print(f"slice custom_voice_bank through the lowered organ: {uv.ORGAN_VOICES} voices, "
          f"{ORGAN_SECONDS:g} s on {card} in {secs:.3f} s (realtime x {ORGAN_SECONDS / secs:.4g}), "
          f"generic_bank launches {organ_launches}; card vs CPU over {ORGAN_CMP_SECONDS:g} s "
          f"{gap:.3e}, the timed render's first chord {head_gap:.3e}, peak {peak:.4g}")
    print(f"  (lowered slices and custom_voice_bank: {time.perf_counter() - t0:.1f} s)")

    # (5) timings
    t0 = time.perf_counter()
    rows = []
    for kind in LOWERED:
        if kind in slices:
            bank, state, launches = slices[kind]
        else:
            bank = make_bank(ktt, np, f"generic-{kind}", LOWERED[kind], SUITE_CAPACITY)
            launches = organ_launches
        if kind in ("lowered-detuned", "lowered-organ"):
            state = sounding_state(torch, ktt, bank)
        row = lowered_timings(torch, np, ktt, kind, bank, state, card)
        r = kernel_row("generic_bank", launches, errs[kind], *row, label=f"generic_bank:{kind}")
        r["source"] = "knaster_tpu_torch/kernels/lower.py"
        rows.append(r)
    print(f"  (lowered timings: {time.perf_counter() - t0:.1f} s)")
    return rows


# --------------------------------------------------------------------------
# the examples that had not run on the port (tools/port_examples.py), and
# BufferReader's block kernel on their path
# --------------------------------------------------------------------------

# (instances, B, channels, dtype) the buffer reader kernel is held at
# against its plain version: buffer_player's mono reader at its block,
# its superblock lengths, several instances in stereo, and f64; then the
# redesign's edges: a tile of shared memory crossed (one f64 reader takes
# 2,976 samples a tile; 70 stereo f64 readers, three CTAs of up to 32,
# take 80) and a bank's width, 16,384 readers at B = 64
READER_CASES = ((1, BLOCK, 1, "f32"), (1, 1024, 1, "f32"), (1, 4096, 1, "f32"),
                (5, BLOCK, 2, "f32"), (5, 1024, 2, "f32"), (1, BLOCK, 1, "f64"),
                (3, 4096, 2, "f64"), (1, 4096, 1, "f64"), (70, 1024, 2, "f64"),
                (16384, BLOCK, 1, "f32"))
READER_FRAMES = 300  # the held buffer's frames: pointers run past its end within a block


def reader_ops_per_sample(C):
    """f32 operations a reader's sample takes (csrc/buffer_reader.cuh
    walk): the restart's two selects and the finished update (3), the two
    clamped frame indices (an add and two compare-selects each: 5), per
    channel the interpolation (subtract, multiply, add) and the finished
    select (4); the pointer's add, floor, conversion, int add, conversion
    back and subtract (6), the end test's conversion, add, compare and two
    logic operations (5), the loop's two selects, the done flag and the
    finished update (4): 23 + 4 a channel."""
    return 23 + 4 * C


def reader_block(torch, np, n, B, C, dtype, dev, seed):
    """(buf, state, planes) on ``dev`` as tests/test_torch_buffer_reader.py
    makes them: pointers inside, past and before the buffer, some readers
    finished, each instance's window start and end (ends inside the
    block), steps of 0.5 to 2 with one of 7.25, restarts and looping
    flags at random."""
    rng = np.random.default_rng(seed)
    frames = READER_FRAMES
    t = lambda a, dt=dtype: torch.from_numpy(np.asarray(a)).to(dev, dt)  # noqa: E731
    buf = t(rng.standard_normal((C, frames)) * 0.5)
    start = np.repeat(rng.uniform(-2.0, frames * 0.5, (n, 1)), B, axis=1)
    start = t(start)
    s_int = torch.floor(start).to(torch.int32)
    state = {"ptr_int": t(rng.integers(-3, frames + 3, n), torch.int32),
             "ptr_frac": t(rng.uniform(0, 1, n)),
             "finished": t(rng.uniform(size=n) < 0.3, torch.bool)}
    step = rng.uniform(0.5, 2.0, (n, B))
    step[:, B // 3] = 7.25
    planes = (s_int, start - s_int.to(dtype),
              start + t(rng.uniform(3.0, frames * 0.7, (n, 1))).expand(n, B),
              t(step), t(rng.uniform(size=(n, 1)) < 0.5, torch.bool).expand(n, B).contiguous(),
              t(rng.uniform(size=(n, B)) < 4.0 / B, torch.bool))
    return buf, state, planes


def buffer_reader_vs_plain(torch, np, dev, card):
    """The buffer reader kernel against ``buffer_reader_block`` on the card
    at READER_CASES (restarts, loops, ends and finished readers in each):
    output, done flags and every state leaf bit-equal. Then its device ms
    at buffer_player's shape (one mono reader, B = 64; in a CUDA graph,
    the eager ms beside) and at 512 samples (the example's superblocks),
    the plain version's ms and the bound. Returns (max |err|,
    ms, plain_ms, bound_ms, bound_by)."""
    from knaster_tpu_torch.kernels import buffer_reader as br
    from knaster_tpu_torch.ugens.buffer import buffer_reader_block

    err, seen = 0.0, {"restart": 0, "done": 0, "silent": 0}
    for k, (n, B, C, dt) in enumerate(READER_CASES):
        dtype = torch.float32 if dt == "f32" else torch.float64
        buf, state, planes = reader_block(torch, np, n, B, C, dtype, dev, 20 + k)
        got_state, got, got_done = br.launch(buf, state, *planes)
        want_state, want, want_done = buffer_reader_block(buf, state, *planes)
        torch.cuda.synchronize()
        words = lambda x: x.view(torch.int64) if x.dtype == torch.float64 else bits(x)  # noqa: E731
        same = (torch.equal(words(got), words(want)) and torch.equal(got_done, want_done)
                and torch.equal(got_state["ptr_int"], want_state["ptr_int"])
                and torch.equal(words(got_state["ptr_frac"]), words(want_state["ptr_frac"]))
                and torch.equal(got_state["finished"], want_state["finished"]))
        if not same:
            fail(f"buffer_reader n={n} B={B} C={C} {dt}: the kernel differs from the plain "
                 f"version by {float((got - want).abs().max())}")
        err = max(err, float((got - want).abs().max()))
        seen["restart"] += int(planes[5].sum())
        seen["done"] += int(want_done.sum())
        seen["silent"] += int((want == 0).sum())
    if not all(seen.values()):
        fail(f"buffer_reader: the cases never reached {[k for k, v in seen.items() if not v]}")
    rows = {}
    for n, B, C in ((1, BLOCK, 1), (1, 8 * BLOCK, 1), (16384, BLOCK, 1), (1, 8192, 1)):
        buf, state, planes = reader_block(torch, np, n, B, C, torch.float32, dev, 40)
        reps = 100 if B <= 8 * BLOCK else 20
        ms = time_graph(torch, lambda: br.launch(buf, state, *planes), reps)
        eager_ms = time_call(torch, lambda: br.launch(buf, state, *planes), reps)
        plain_ms = (time_call(torch, lambda: buffer_reader_block(buf, state, *planes), 1)
                    if B <= 8 * BLOCK else float("nan"))
        out_state, out, done = br.launch(buf, state, *planes)
        # each plane and state leaf read once, the outputs written once, and
        # of the buffer at most the two frames a sample reads
        touched = min(buf.numel(), 2 * n * B * C) * buf.element_size()
        nbytes = tensor_bytes(state, planes, out_state, out, done) + touched
        b_ms, b_by = bound(nbytes, reader_ops_per_sample(C) * n * B)
        rows[(n, B)] = (ms, plain_ms, b_ms, b_by)
        print(f"timing buffer_reader n={n} B={B} C={C} on {card}: kernel {ms:.4f} ms (eager "
              f"{eager_ms:.4f}), plain {plain_ms:.3f} ms, bound {b_ms:.7f} ms ({b_by}, "
              f"{reader_ops_per_sample(C)} operations a sample)")
    print(f"buffer_reader on {card}: kernel bit-equal to the plain version at (instances, B, "
          f"channels, dtype) {READER_CASES} ({seen['restart']} restarts, {seen['done']} done "
          f"flags, {seen['silent']} finished samples)")
    return (err, *rows[(1, BLOCK)])


# (instances, B, dtype) the SVF kernel is held at against its plain
# version: a graph node's blocks and superblocks, the 704-sample superblocks
# under a Galactic (live_edit), a vmap bank's 1024 voices, and f64
SVF_CASES = ((1, BLOCK, "f32"), (1, 704, "f32"), (1, 4096, "f32"), (1024, BLOCK, "f32"),
             (31, 1024, "f32"), (1, BLOCK, "f64"), (4, 4096, "f64"))


def svf_ops_per_sample():
    """The operations a sample of the SVF takes, as the function needs
    them (not as the kernel's scan spends them): the coefficients once
    (pow, sqrt, the tangent's two polynomials and quotient ~22; g, k and
    a1-a3 8; the m's selects ~6: 36) and the recurrence in its sequential
    form (svf.rs:270-300): v3 (1), v1 (3), v2 (4), the output (5) and the
    next state, 2 v1 - s0 and 2 v2 - s1 (4): 53."""
    return 36 + 17


def svf_block_operands(torch, np, n, B, dtype, dev, seed):
    """(ic, x, (the filter type, cutoff, q, gain)) on ``dev``: every filter
    type across the instances, a cutoff glide over 30 Hz - 20 kHz, an
    audio-rate q, gains of -12 to 12 dB."""
    rng = np.random.default_rng(seed)
    t = lambda a, dt=dtype: torch.from_numpy(np.asarray(a)).to(dev, dt)  # noqa: E731
    ty = t(np.repeat(np.arange(n) % 9, B).reshape(n, B), torch.int32)
    cutoff = t(np.exp(np.linspace(np.log(30.0), np.log(20000.0), B))[None, :]
               * rng.uniform(0.5, 1.0, (n, 1)))
    q = t(rng.uniform(0.3, 8.0, (n, B)))
    gain = t(np.repeat(rng.uniform(-12.0, 12.0, (n, 1)), B, axis=1))
    return t(rng.standard_normal((n, 2))), t(rng.standard_normal((n, B))), (ty, cutoff, q, gain)


def svf_filter_vs_plain(torch, np, dev, card):
    """The SVF kernel against ``svf_block`` on the card at SVF_CASES (the
    nine filter types across the instances, the single ones Low; audio-rate
    cutoff and q; gains of +-12 dB): output and state bit-equal. Then its
    device ms at live_edit's shape (one filter, the 704-sample superblocks
    under its Galactic; in a CUDA graph, the eager ms beside) and at B =
    64, the plain version's ms and the bound. Returns (max |err|, ms,
    plain_ms, bound_ms, bound_by) at 704."""
    from knaster_tpu_torch.kernels import svf_filter as sk
    from knaster_tpu_torch.ugens.filters import svf_block

    err = 0.0
    for k, (n, B, dt) in enumerate(SVF_CASES):
        dtype = torch.float32 if dt == "f32" else torch.float64
        ic, x, params = svf_block_operands(torch, np, n, B, dtype, dev, 60 + k)
        got_ic, got = sk.launch(ic, x, *params, SR)
        want_ic, want = svf_block(ic, x, *params, SR)
        torch.cuda.synchronize()
        words = lambda v: v.view(torch.int64) if v.dtype == torch.float64 else bits(v)  # noqa: E731
        if not (torch.equal(words(got), words(want)) and torch.equal(words(got_ic),
                                                                      words(want_ic))):
            fail(f"svf_filter n={n} B={B} {dt}: the kernel differs from the plain version by "
                 f"{float((got - want).abs().max())}")
        if not bool(torch.isfinite(got).all()):
            fail(f"svf_filter n={n} B={B} {dt}: not finite")
        err = max(err, float((got - want).abs().max()))
    rows = {}
    for B in (704, BLOCK):
        ic, x, params = svf_block_operands(torch, np, 1, B, torch.float32, dev, 70)
        ms = time_graph(torch, lambda: sk.launch(ic, x, *params, SR), 100)
        eager_ms = time_call(torch, lambda: sk.launch(ic, x, *params, SR), 100)
        plain_ms = time_call(torch, lambda: svf_block(ic, x, *params, SR), 3)
        out_ic, out = sk.launch(ic, x, *params, SR)
        b_ms, b_by = bound(tensor_bytes(ic, x, params, out_ic, out), svf_ops_per_sample() * B)
        rows[B] = (ms, plain_ms, b_ms, b_by)
        print(f"timing svf_filter n=1 B={B} on {card}: kernel {ms:.4f} ms (eager "
              f"{eager_ms:.4f}), plain {plain_ms:.3f} ms, bound {b_ms:.7f} ms ({b_by}, "
              f"{svf_ops_per_sample()} operations a sample)")
    print(f"svf_filter on {card}: kernel bit-equal to the plain version at (instances, B, "
          f"dtype) {SVF_CASES}")
    return (err, *rows[704])


# (B, dtype) the Galactic kernel is held at against its plain version: a
# graph's block, the 704-sample superblocks under its cap at 48 kHz
# (live_edit), the cap itself, and f64
GALACTIC_CASES = ((BLOCK, "f32"), (704, "f32"), (740, "f32"), (1, "f32"), (BLOCK, "f64"),
                  (704, "f64"))


def galactic_ops_per_sample():
    """The operations a sample of Galactic's blockwise block takes for both
    channels, as the function needs them (each lowpass as its sequential
    recurrence, not the kernel's scan), counted a channel: the silence test
    and the ring write (4), the vibrato read (6), each lowpass's y = (1 -
    lp) y + lp x (4), the twelve line reads' and twelve writes' index
    arithmetic (2 each), the three Householder mixes (11 each), the
    feedback write (2), the last bank's sum (4), the wet/dry mix (5) and
    the dither (8): 118, twice."""
    return 2 * 118


def galactic_operands(torch, np, ktt, B, dtype, dev, seed):
    """``blockwise_rest``'s operands on ``dev`` as ``Galactic.process`` makes
    them, from a moved state (lines full of noise at random positions, the
    vibrato ring, feedback and lowpasses anywhere, the vibrato phase near
    its reset), a half-silent input and random params."""
    rng = np.random.default_rng(seed)
    ctx = ktt.AudioCtx(SR, B, dtype)
    ugen = ktt.Galactic(seed=seed)
    s = ugen.init(ctx, device=dev)
    t = lambda a, dt=dtype: torch.from_numpy(np.asarray(a)).to(dev, dt)  # noqa: E731
    base, lmax = ugen._geometry(SR)
    s["dbuf"] = t(rng.standard_normal(tuple(s["dbuf"].shape)) * 0.3)
    s["dpos"] = t(rng.integers(0, base // 2, (2, 12)), torch.int32)
    s["vib_buf"] = t(rng.standard_normal((2, 256)) * 0.3)
    s["vib_pos"] = t(rng.integers(0, 256, 2), torch.int32)
    s["feedback"] = t(rng.standard_normal((2, 4)) * 0.1)
    s["iir_a"], s["iir_b"] = t(rng.standard_normal(2) * 0.2), t(rng.standard_normal(2) * 0.2)
    s["vib_m"] = t(6.2)
    x = rng.standard_normal((2, B)) * 0.5
    x[:, : B // 2] = 0.0
    params = {k: t(np.full(B, rng.uniform(lo, hi))) for k, lo, hi in (
        ("replace", 0.0, 1.0), ("detune", 0.2, 1.0), ("brightness", 0.2, 1.0),
        ("bigness", 0.1, 1.0), ("wet", 0.1, 0.9))}
    regen, attenuate, lowpass, drift, wet = ugen._rates(ctx, params)
    size = params["bigness"][0] * 0.9 + 0.1
    eff = (t(base) * size).to(torch.int32).clamp(B + 1, lmax).long()
    off, tiny, fpd_seq, _, _, _ = ugen._vib_fpd_vectorized(ctx, s, drift)
    return (s, t(x), attenuate, lowpass, regen, wet, off, tiny, fpd_seq, eff)


def galactic_vs_plain(torch, np, ktt, dev, card):
    """The Galactic kernel against ``blockwise_rest`` on the card at
    GALACTIC_CASES: the output and every state leaf bit-equal. Then its
    device ms at live_edit's shape (B = 704; in a CUDA graph, the eager ms
    beside) and at B = 64, the plain version's ms and the bound (the lines'
    touched values read and written once). Returns (max |err|, ms,
    plain_ms, bound_ms, bound_by) at 704."""
    from knaster_tpu_torch.airwindows.galactic import blockwise_rest
    from knaster_tpu_torch.kernels import galactic as gk

    err = 0.0
    for k, (B, dt) in enumerate(GALACTIC_CASES):
        dtype = torch.float32 if dt == "f32" else torch.float64
        ops = galactic_operands(torch, np, ktt, B, dtype, dev, 80 + k)
        got_state, got = gk.launch(*ops)
        want_state, want = blockwise_rest(*ops)
        torch.cuda.synchronize()
        words = lambda v: (v.view(torch.int64) if v.dtype == torch.float64 else  # noqa: E731
                           bits(v) if v.dtype == torch.float32 else v)
        bad = [k2 for k2 in want_state if not torch.equal(words(got_state[k2]),
                                                          words(want_state[k2]))]
        if bad or not torch.equal(words(got), words(want)):
            fail(f"galactic B={B} {dt}: the kernel differs from the plain version (output by "
                 f"{float((got - want).abs().max())}, state leaves {bad})")
        err = max(err, float((got - want).abs().max()))
    rows = {}
    for B in (704, BLOCK):
        ops = galactic_operands(torch, np, ktt, B, torch.float32, dev, 90)
        ms = time_graph(torch, lambda: gk.launch(*ops), 50)
        eager_ms = time_call(torch, lambda: gk.launch(*ops), 50)
        plain_ms = time_call(torch, lambda: blockwise_rest(*ops), 5)
        new, out = gk.launch(*ops)
        # the block's inputs, rows and streams, the small state leaves, the
        # output, and of the lines what the block reads and writes
        small = {k: v for k, v in ops[0].items() if k != "dbuf"}
        nbytes = (tensor_bytes(ops[1:], small, {k: v for k, v in new.items() if k != "dbuf"},
                               out) + 2 * 2 * 12 * B * out.element_size())
        b_ms, b_by = bound(nbytes, galactic_ops_per_sample() * B)
        rows[B] = (ms, plain_ms, b_ms, b_by)
        print(f"timing galactic B={B} on {card}: kernel {ms:.4f} ms (eager {eager_ms:.4f}), "
              f"plain {plain_ms:.3f} ms, bound {b_ms:.7f} ms ({b_by}, "
              f"{galactic_ops_per_sample()} operations a sample)")
    print(f"galactic on {card}: kernel bit-equal to the plain version at (B, dtype) "
          f"{GALACTIC_CASES}")
    return (err, *rows[704])


# (instances, B, path, dtype) the EnvAsr kernel is held at against its
# plain version: the state machine (eventful blocks, voice banks), the
# closed form over Hillis-Steele sums (graph nodes) and over base-16 sums
# (the voice models), a node's block and superblocks, a bank's 1024 voices;
# then the redesign's edges: the state machine's shared-memory tiles crossed
# (3 f64 instances at 4096 samples take 1,920 a tile), instances past a
# CTA's (32 a CTA on the state machine; 1000 at 4 a CTA on the closed
# form), the in-place Hillis-Steele rows at their largest (8192,
# f64, 16 lanes a thread over the barrier), the rows past shared memory in
# the global workspace (Hillis-Steele past 8192, base-16 f64 past ~12,800),
# and a bank's width, 16,384 instances at B = 64, on all three paths
ENV_CASES = ((1, BLOCK, "step", "f32"), (1, 704, "step", "f32"), (1024, BLOCK, "step", "f32"),
             (1, BLOCK, "hillis_steele", "f32"), (1, 4096, "hillis_steele", "f32"),
             (1, 704, "base16", "f32"), (1024, BLOCK, "base16", "f32"),
             (1, 4096, "base16", "f32"), (3, 1024, "step", "f64"),
             (3, 1024, "hillis_steele", "f64"), (3, 1024, "base16", "f64"),
             (1024, BLOCK, "step", "f64"), (3, 4096, "step", "f64"),
             (1000, BLOCK, "hillis_steele", "f32"), (1, 8192, "hillis_steele", "f64"),
             (2, 16384, "hillis_steele", "f64"), (1, 8192, "base16", "f64"),
             (2, 16384, "base16", "f64"), (16384, BLOCK, "step", "f32"),
             (16384, BLOCK, "hillis_steele", "f32"), (16384, BLOCK, "base16", "f32"))
# the same forced into the global workspace: the layout past shared memory
# at a length whose rows would fit
ENV_GLOBAL_CASES = ((1, 8192, "hillis_steele", "f64"), (2, 704, "base16", "f64"),
                    (1000, BLOCK, "hillis_steele", "f32"))
# f32 operations a sample of the state machine takes (env_asr.cuh step):
# the restart and release selects (6), the output's chain (5), the next t
# (3), the sustain and done tests and selects (7)
ENV_STEP_OPS = 21


def env_asr_operands(torch, np, n, B, dtype, dev, seed):
    """(state, atk, rel, restart, release) on ``dev`` as
    tests/test_torch_env_asr.py makes them: every stage, t anywhere in [0,
    1] and at 1, attack and release times from 0 (an instant rate) to ~10
    blocks, a few restarts and releases."""
    from knaster_tpu_torch.ugens.envelopes import rate_from_time

    rng = np.random.default_rng(seed)
    t = lambda a, dt=dtype: torch.from_numpy(np.asarray(a)).to(dev, dt)  # noqa: E731
    tt = rng.uniform(0.0, 1.0, n)
    tt[::5] = 1.0
    state = {"stage": t(rng.integers(0, 4, n), torch.int32), "t": t(tt),
             "release_scale": t(rng.uniform(0.2, 1.0, n))}
    times = rng.uniform(0.0, 10 * B / SR, (n, 1)) * (rng.uniform(size=(n, 1)) > 0.1)
    atk = rate_from_time(t(np.repeat(times, B, axis=1)), SR)
    rel = rate_from_time(t(np.repeat(rng.uniform(0.0, 10 * B / SR, (n, 1)), B, axis=1)), SR)
    return (state, atk, rel, t(rng.uniform(size=(n, B)) < 2.0 / B, torch.bool),
            t(rng.uniform(size=(n, B)) < 2.0 / B, torch.bool))


def env_asr_vs_plain(torch, np, dev, card):
    """The EnvAsr kernel against ``asr_block`` on the card at ENV_CASES in
    the layout the kernel picks and at ENV_GLOBAL_CASES forced into the
    global workspace (every stage, restarts and releases, attacks that
    reach 1, releases that end in the block): outputs, done flags and state
    bit-equal. Then its device ms (in a CUDA graph, the eager ms beside) on
    the state machine at live_edit's shape (one envelope, B = 64, the
    eventful blocks), on the base-16 closed form at 704 (its superblocks),
    at a bank's width (16,384 instances at B = 64) on all three paths and
    on both closed forms at 8192, with the plain version's ms and the
    bound. Returns (max |err|, ms, plain_ms, bound_ms, bound_by) on the
    state machine at live_edit's shape."""
    from knaster_tpu_torch.core.dsp import cumsum, cumsum_base16
    from knaster_tpu_torch.kernels import env_asr as ek
    from knaster_tpu_torch.ugens.envelopes import asr_block

    paths = {"step": (False, cumsum), "hillis_steele": (True, cumsum),
             "base16": (True, cumsum_base16)}
    modes = {"step": ek.STEP, "hillis_steele": ek.HILLIS_STEELE, "base16": ek.BASE16}
    err, layouts = 0.0, set()
    cases = [(c, ek.launch) for c in ENV_CASES] + [(c, ek.launch_global)
                                                   for c in ENV_GLOBAL_CASES]
    for k, ((n, B, path, dt), launch) in enumerate(cases):
        dtype = torch.float32 if dt == "f32" else torch.float64
        ops = env_asr_operands(torch, np, n, B, dtype, dev, 100 + k)
        got = launch(*ops, *paths[path])
        want = asr_block(*ops, *paths[path])
        torch.cuda.synchronize()
        words = lambda v: (v.view(torch.int64) if v.dtype == torch.float64 else  # noqa: E731
                           bits(v) if v.dtype == torch.float32 else v)
        same = all(torch.equal(words(g), words(w.expand_as(g).to(g.dtype)))
                   for g, w in zip(got, want))
        glob = ek.workspace_len(B, dtype, modes[path], launch is ek.launch_global) > 0
        where = (f"env_asr n={n} B={B} {path} {dt}"
                 f"{' (global workspace)' if glob else ''}")
        if not same:
            fail(f"{where}: the kernel differs from the plain version (output by "
                 f"{float((got[3] - want[3]).abs().max())})")
        err = max(err, float((got[3] - want[3]).abs().max()))
        layouts.add("tiles" if path == "step" else "global" if glob else "shared")
    if layouts != {"tiles", "shared", "global"}:
        fail(f"env_asr: the cases took the layouts {sorted(layouts)} only")
    rows = {}
    for n, B, path in ((1, BLOCK, "step"), (1, 704, "base16"), (16384, BLOCK, "step"),
                       (16384, BLOCK, "hillis_steele"), (16384, BLOCK, "base16"),
                       (1, 8192, "hillis_steele"), (1, 8192, "base16")):
        ops = env_asr_operands(torch, np, n, B, torch.float32, dev, 120)
        reps = 100 if B <= 704 else 20
        ms = time_graph(torch, lambda: ek.launch(*ops, *paths[path]), reps)
        eager_ms = time_call(torch, lambda: ek.launch(*ops, *paths[path]), reps)
        plain_ms = time_call(torch, lambda: asr_block(*ops, *paths[path]),
                             1 if path == "step" and B > 704 else 3)
        got = ek.launch(*ops, *paths[path])
        # the closed form: two prefix sums (B - 1 adds each) and ~14 a lane
        n_ops = n * (ENV_STEP_OPS * B if path == "step" else (2 * (B - 1) + 14 * B))
        b_ms, b_by = bound(tensor_bytes(ops, got), n_ops)
        rows[(n, B, path)] = (ms, plain_ms, b_ms, b_by)
        print(f"timing env_asr n={n} B={B} {path} on {card}: kernel {ms:.4f} ms (eager "
              f"{eager_ms:.4f}), plain {plain_ms:.3f} ms, bound {b_ms:.7f} ms ({b_by})")
    print(f"env_asr on {card}: kernel bit-equal to the plain version at (instances, B, path, "
          f"dtype) {ENV_CASES} and, in the global workspace, {ENV_GLOBAL_CASES}")
    return (err, *rows[(1, BLOCK, "step")])


# each example's card render (tools/port_examples.py's cut keywords) and
# the port's CPU render its first frames are held against (the card renders
# those frames alone first, as the CPU render does). The wavetable
# orchestra at its full 16,384 voices and 10 s (its trigger and release
# waves) and its first 4 blocks on the CPU, whose plain bank takes ~0.1 s a
# block there; the eager graphs cut for the run's time (realtime x on an
# H100 before the SVF, Galactic and EnvAsr kernels: visualize_graph 0.049,
# many_sines 0.18, voice_pool 0.15, plucked_strings 0.089, the shimmer
# 0.092, the grain texture 0.18 after its 1 s source); the grain source
# renders its 1 s
EXAMPLE_RUNS = {
    "simple_sine": ({}, {"seconds": 0.1}),
    "visualize_graph": ({"seconds": 0.25}, {"seconds": 0.1}),
    "many_sines": ({"seconds": 0.5}, {"seconds": 0.1}),
    "voice_pool": ({"notes": 60, "tail": 0.25}, {"notes": 50, "tail": 0}),
    "wavetable_orchestra": ({}, {"seconds": 4 * BLOCK / SR}),
    "plucked_strings": ({"seconds": 0.25}, {"seconds": 0.1}),
    "plucked_shimmer": ({"seconds": 0.25}, {"seconds": 0.1}),
    "granular_texture": ({"seconds": 0.5}, {"seconds": 0.1}),
    "granular_ensemble": ({"seconds": 0.5}, {"seconds": 0.1}),
    "ir_reverb": ({}, {"seconds": 0.1}),
    "buffer_player": ({}, {"seconds": 0.1}),
}
# card vs CPU, x max(1, peak): tests/test_torch_examples.py's gates; the
# grain ensemble's 1e-5 also covers the card's cosf, sinf and exp2f against
# the CPU's (an ulp on some inputs moves a grain's frozen step and pan
# gains: BUFFER_CONFIGS' granular gate)
EXAMPLE_GATE = 1e-6
EXAMPLE_GATES = {"granular_ensemble": 1e-5}
# the port kernels each example must launch, and no other (the Galactic
# reverb's in the examples that end in one)
EXAMPLE_KERNELS = {"wavetable_orchestra": ("wt_bank",),
                   "visualize_graph": ("svf_filter", "env_asr"), "many_sines": ("env_asr",),
                   "voice_pool": ("galactic", "env_asr"), "granular_texture": ("galactic",),
                   "buffer_player": ("buffer_reader", "galactic"),
                   "live_edit": ("svf_filter", "galactic", "env_asr")}


def examples_module():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import port_examples

    return port_examples


def phase_examples(torch, np, ktt, dev, card):
    """The ten examples of tools/port_examples.py on the card.

    Each renders at its EXAMPLE_RUNS cut through the port's public API on
    the card (counts reset just before, read just after), its first frames
    held against the port's CPU render of them within EXAMPLE_GATE (or
    EXAMPLE_GATES); finite and sounding; realtime x over the whole bounce
    (its first render's compile and warm included) and after the head.
    Each example must launch every kernel EXAMPLE_KERNELS lists for it and
    no other: ``wavetable_orchestra`` at 16,384 voices the wavetable
    kernel; ``buffer_player`` the buffer reader and Galactic kernels;
    ``visualize_graph`` the SVF and EnvAsr kernels; ``many_sines`` EnvAsr's
    (its 600 voices' envelopes); ``voice_pool`` Galactic's and EnvAsr's;
    ``granular_texture`` Galactic's; the others (``simple_sine``, the two
    plucked examples, ``granular_ensemble``, ``ir_reverb``) none.
    ``visualize_graph`` prints its dot source's size and what
    ``show_dot_svg`` returned. ``live_edit`` streams the example (1.5 s,
    the live Galactic insert, 2 s, the release, 2 s): it must swap to the
    edit's revision, write finite, sounding audio, keep the ring at
    LIVE_WRITTEN of real time and launch the SVF, Galactic and EnvAsr
    kernels and no other; its underruns and chunk ms are printed, not
    gated. Then the four UGen kernels against their plain versions
    (``buffer_reader_vs_plain``, ``svf_filter_vs_plain``,
    ``galactic_vs_plain``, ``env_asr_vs_plain``). Returns the kernels
    line's rows of those four."""
    pe = examples_module()
    launches = {}

    def example_kernels(counts, name):
        """The example's kernels launched, and no other."""
        expect_ugen_kernels(counts, EXAMPLE_KERNELS.get(name, ()), f"example {name}")
        launches[name] = {k: counts[k] for k in EXAMPLE_KERNELS.get(name, ())}
    for name, (card_kw, cpu_kw) in EXAMPLE_RUNS.items():
        t0 = time.perf_counter()
        head = cpu_kw.get("seconds")
        reset_all_counts()
        run = pe.play(name, ktt, dev, head=head, **card_kw)
        counts = {k: n for k, n in read_all_counts().items() if n}
        tally = launch_tally()
        cpu = pe.play(name, ktt, "cpu", **cpu_kw).audio()
        audio = run.audio()
        peak = float(np.abs(audio).max())
        gap = float(np.abs(audio[:, :cpu.shape[1]] - cpu).max())
        gate = EXAMPLE_GATES.get(name, EXAMPLE_GATE) * max(1.0, peak)
        if not np.isfinite(audio).all() or peak < 1e-3 or gap > gate:
            fail(f"example {name}: card vs CPU {gap} over {cpu.shape[1]} frames (gate {gate}, "
                 f"peak {peak}, finite {bool(np.isfinite(audio).all())})")
        example_kernels(counts, name)
        extra = ""
        if name == "visualize_graph":
            extra = f"; dot {len(run.info['dot'])} chars, show_dot_svg -> {run.info['svg']}"
        if name == "voice_pool":
            extra = f"; {run.info['scheduled']} notes, {run.info['free']} voices free at the end"
        if name == "buffer_player":
            extra = f"; launches by block length {tally}"
        print(f"example {name} ({pe.SOURCES[name]}, cut {card_kw or 'none'}) on {card}: "
              f"{audio.shape[1] / SR:.3f} s of audio, realtime x {run.realtime_x():.4g} "
              f"({run.realtime_x(1):.4g} after its first render); card vs CPU {gap:.3e} over "
              f"{cpu.shape[1]} frames (gate {gate:.1e}, peak {peak:.4g}); launches {counts}"
              f"{extra} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    reset_all_counts()
    run = pe.play("live_edit", ktt, dev)
    counts = {k: n for k, n in read_all_counts().items() if n}
    tally = launch_tally()
    info, audio = run.info, run.audio()
    peak = float(np.abs(audio).max())
    print(f"example live_edit ({pe.SOURCES['live_edit']}) on {card}: start-up "
          f"{info['startup_s']:.2f} s; the swap to revision {info['revision']} seen "
          f"{info['swap_s']:.2f} s after the edit ({info['swaps'][-1:]}); {info['underruns']} "
          f"underruns; written {info['written_over_wall']:.3f} of real time over "
          f"{info['wall_s']:.2f} s; {info['chunks']} chunks, host ms median "
          f"{info['chunk_ms_median']:.2f}, max {info['chunk_ms_max']:.2f}, median after the "
          f"swap {info['chunk_ms_median_after']:.2f} (a chunk is {32 * BLOCK / SR * 1e3:.2f} ms "
          f"of audio); peak {peak:.4g}; launches {counts}; by block length {tally} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not (info["swapped"] and info["swaps"] and info["swaps"][-1][0] == info["revision"]):
        fail(f"example live_edit: no swap to revision {info['revision']}: {info['swaps']}")
    if not np.isfinite(audio).all() or peak < 1e-3:
        fail(f"example live_edit: the stream's audio is not finite or silent (peak {peak})")
    if info["written_over_wall"] < LIVE_WRITTEN:
        fail(f"example live_edit: the ring took {info['frames_written']} frames in "
             f"{info['wall_s']:.2f} s ({info['written_over_wall']:.3f} of real time, floor "
             f"{LIVE_WRITTEN})")
    example_kernels(counts, "live_edit")
    return [kernel_row("buffer_reader", launches["buffer_player"]["buffer_reader"],
                       *buffer_reader_vs_plain(torch, np, dev, card),
                       label="buffer_reader:buffer_player"),
            kernel_row("svf_filter", counts["svf_filter"], *svf_filter_vs_plain(
                torch, np, dev, card), label="svf_filter:live_edit"),
            kernel_row("galactic", counts["galactic"], *galactic_vs_plain(
                torch, np, ktt, dev, card), label="galactic:live_edit"),
            kernel_row("env_asr", counts["env_asr"], *env_asr_vs_plain(torch, np, dev, card),
                       label="env_asr:live_edit")]


def phase_family_timings(torch, ktt, kind, bank, state, card):
    """The generic kernel with the Envelope or Modal body, event-free from
    the slice's state, at B in {64, 1024} (CUDA events over back-to-back
    launches into preallocated outputs), the plain version's ms at B = 64,
    the bound at each B. Returns (ms, plain_ms, bound_ms, bound_by) at
    B = 64."""
    from knaster_tpu_torch.kernels import generic_bank as gk

    spec = bank.spec(ktt.AudioCtx(SR, BLOCK, torch.float32))
    line, row = [], None
    for B in (BLOCK, 1024):
        ctx = ktt.AudioCtx(SR, B, torch.float32)
        ops, _ = bank.kernel_operands(ctx, state, None)
        moving = moving_pans(torch, bank, ops, B)
        per_sample = (envelope_ops(bank.voice.env, moving) if kind == "envelope"
                      else modal_ops(bank.voice.res.n_modes, moving))
        outs = gk.empty_outputs(ops["carry"], bank.voice.outputs, B)
        reps = 100 if B == BLOCK else 20
        ms = time_graph(torch, lambda: gk.launch(outs, **ops), reps)
        eager_ms = time_call(torch, lambda: gk.launch(outs, **ops), reps)
        b_ms, b_by = bound(tensor_bytes(ops, written(gk, outs)), per_sample * bank.n_voices * B)
        line.append(f"B={B} kernel {ms:.4f} ms (eager {eager_ms:.4f}; bound {b_ms:.5f} ms, "
                    f"{b_by}, {per_sample:.0f} f32 operations a voice-sample)")
        if B == BLOCK:
            ev = bank.node_events_from_lists(
                body_schedule(bank, bank.n_voices, B)[0][:bank.event_capacity])
            ev_ops, _ = bank.kernel_operands(ctx, state, ev)
            ev_ms = time_graph(torch, lambda: gk.launch(outs, **ev_ops), reps)
            plain_ms = time_call(torch, lambda: gk.generic_bank_plain(**ops), 2)
            row = (ms, plain_ms, b_ms, b_by)
            line.append(f"eventful kernel {ev_ms:.4f} ms; plain {plain_ms:.3f} ms")
    print(f"timing generic_bank:{kind} ({spec.cuda_body}) V={bank.n_voices} on {card}: "
          + "; ".join(line))
    return row


def kernel_row(name, launches, err, ms, plain_ms, bound_ms, bound_by, label=None):
    """One entry of the kernels line. No single PyTorch call computes any of
    these DSP kernels' functions, so ``library_ms`` is null."""
    return {"name": label or name, "route": "cuda",
            "source": f"knaster_tpu_torch/csrc/{name}.cu", "replaces": REPLACES[name],
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def print_ptxas(paths):
    """Each library's nvcc seconds and each kernel instantiation's registers
    and spills from the ``ptxas -v`` log beside each library, one line an
    instantiation, named as ``c++filt`` demangles it where the toolchain has
    one."""
    import re

    from knaster_tpu_torch.kernels.build import build_seconds

    for name, so in paths.items():
        print(f"  nvcc {name}: {build_seconds(so)} s")
        entries, cur = [], None
        for line in so.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = [m.group(1), "", ""]
                entries.append(cur)
            elif cur is not None and "spill" in line:
                cur[1] = line.strip()
            elif cur is not None and "registers" in line:
                cur[2] = line.split(":", 1)[-1].strip()
        try:
            names = subprocess.run(["c++filt"], input="\n".join(e[0] for e in entries),
                                   capture_output=True, text=True, timeout=60).stdout.split("\n")
        except OSError:
            names = []
        for k, (mangled, spill, regs) in enumerate(entries):
            full = names[k] if k < len(names) and names[k] else mangled
            short = full.replace("(anonymous namespace)::", "").split("(")[0]
            print(f"  ptxas {name}: {short.removeprefix('void ')}: {regs}; {spill}")


def lap(phase, *args):
    """``phase(*args)``, printing its wall time (the run's time budget). The
    program and plan caches are emptied first: a phase's compiles reuse
    only what that phase built."""
    from knaster_tpu_torch.graph.compile import clear_program_cache

    clear_program_cache()
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"  ({phase.__name__}: {time.perf_counter() - t0:.1f} s)")
    return out


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    import knaster_tpu_torch as ktt
    from knaster_tpu_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_name_and_limit()
    print(f"device: {torch.cuda.get_device_name(0)} ({card}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    uv = user_voices_module()
    user_sources = {"user-detuned": uv.DETUNED_SOURCE, "user-organ": uv.ORGAN_SOURCE}
    lowered = lowered_sources(torch, np, ktt)
    user_sources.update({kind: lb.source for kind, lb in lowered.items()})
    t_lower = time.perf_counter() - t0
    paths = build.build_all(user_sources=tuple(user_sources.values()))
    for name in paths:
        build.load_library(name)
    for src in user_sources.values():
        build.load_user_body(src)
    print(f"build: {len(paths)} libraries and {len(user_sources)} user voice bodies "
          f"({len(lowered)} lowered from torch bodies in {t_lower:.1f} s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for kind, lb in lowered.items():
        print(f"  {kind}: {lb.voice_name} lowered, {lb.counts[2]} carry words, "
              f"{lb.ops_per_sample} operations a voice-sample, "
              f"{build.user_body_path(lb.source).name}")
    print_ptxas({**paths, **{n: build.user_body_path(src) for n, src in user_sources.items()}})

    # -- kernel vs plain --------------------------------------------------
    t0 = time.perf_counter()
    errs, errs_by_body = {}, {}
    for kind in ("sine", "fm", "sub", "wt", "generic-sine", "generic-fm",
                 "generic-subtractive", "generic-additive"):
        name = kernel_module(kind).KERNEL
        # B = 64 only, the slices' block, to keep the whole run within its
        # time limit
        t1 = time.perf_counter()
        err = phase_kernel_vs_plain(torch, np, ktt, dev, kind, Bs=(BLOCK,))
        print(f"  ({kind}: {time.perf_counter() - t1:.1f} s)")
        errs[name] = max(errs.get(name, 0.0), err)
        if kind.startswith("generic"):
            errs_by_body[kind[8:]] = err
    errs["fm_cascade"] = lap(phase_fm_cascade_vs_plain, torch, np, dev)
    errs["chain_kernel"] = max(lap(phase_chain_vs_plain, torch, np, ktt, dev),
                               lap(phase_bodies_vs_plain, torch, ktt, dev))
    path_errs = lap(phase_subtractive_vs_plain, torch, np, ktt, dev)
    osc_errs, _ = lap(phase_float_osc_vs_plain, torch, np, ktt, dev)
    path_errs.update(osc_errs)
    path_errs.update(lap(phase_subtractive_vs_plain, torch, np, ktt, dev,
                         None, STAGE_BLOCKS, noise_delay_paths(ktt)))
    global_errs = lap(phase_global_rows_vs_plain, torch, np, ktt, dev, card)
    errs["chain_kernel"] = max([errs["chain_kernel"], *global_errs.values(),
                                *path_errs.values()])
    family_errs, efrom_ulps = lap(phase_family_vs_plain, torch, np, ktt, dev)
    matrix_errs = lap(phase_bank_matrix_vs_plain, torch, np, ktt, dev)
    for kind in ("wt",) + HAND_KINDS:
        name = kernel_module(kind).KERNEL
        errs[name] = max(errs[name], matrix_errs[kind])
    for body in ("sine", "fm", "subtractive", "additive"):
        errs_by_body[body] = max(errs_by_body[body], matrix_errs[f"generic-{body}"])
    for body in ("envelope", "modal"):
        family_errs[body] = max(family_errs[body], matrix_errs[f"generic-{body}"])
    lap(phase_kernels_vs_vmap, torch, np, ktt, dev)
    print(f"kernel vs plain: {time.perf_counter() - t0:.1f} s")

    # -- the slices -------------------------------------------------------
    t0 = time.perf_counter()
    ctx = ktt.AudioCtx(SR, BLOCK, torch.float32)
    results = {}
    body_errs = {}  # the generic harness's bodies: max |mix diff| each
    for kind, sustains in (("sine", True), ("fm", False), ("generic-fm", False),
                           ("sub", True), ("wt", True), ("generic-sine", True),
                           ("generic-subtractive", True), ("generic-additive", True)):
        bank, state, launches, outs, _, _ = phase_slice(
            torch, np, ktt, dev, kind, card, sustains)
        # the slice's final state, one more block, kernel against plain
        operands, _ = bank.kernel_operands(ctx, state, None)
        _, err, _ = compare_block(torch, kind, bank, operands,
                               f"slice {kind} final block")
        name = kernel_module(kind).KERNEL
        errs[name] = max(errs[name], err)
        if kind.startswith("generic"):
            body_errs[kind[8:]] = err
        results[kind] = (bank, state, launches, outs)
    for body in ("sine", "fm", "subtractive", "additive"):
        body_errs[body] = max(body_errs[body], errs_by_body[body])
    for kind in ("envelope", "modal"):
        bank, state, launches = phase_family_slice(torch, np, ktt, dev, kind, card)
        operands, _ = bank.kernel_operands(ctx, state, None)
        _, err, _ = compare_block(torch, "generic", bank, operands,
                                  f"slice {kind}_bank final block",
                                  loose=(3,) if kind == "envelope" else ())
        body_errs[kind] = max(err, family_errs[kind])
        results[f"generic-{kind}"] = (bank, state, launches, None)
    # the generic harness with the FM body against the hand FM bank
    (_, s_hand, _, o_hand), (_, s_gen, _, o_gen) = results["fm"], results["generic-fm"]
    for key in ("phm", "phc", "stage", "t", "idle"):
        if not torch.equal(s_hand[key], s_gen[key]):
            fail(f"generic FM slice: {key} differs from the hand FM bank")
    gap = float((o_hand - o_gen).abs().max())
    if gap > 5e-7 * math.sqrt(N_VOICES / 512):
        fail(f"generic FM slice: mix differs from the hand FM bank by {gap}")
    print(f"slice generic-fm vs fm: state equal, max |mix diff| {gap:.3e}")
    print(f"  (bank slices: {time.perf_counter() - t0:.1f} s)")
    stage_launches = lap(phase_graph_slices, torch, np, ktt, dev, card)
    path_launches = lap(phase_subtractive_slices, torch, np, ktt, dev, card)
    lap(phase_param_sweep, torch, np, ktt, dev, card)
    partitions = lap(phase_partitions, torch, np, ktt, dev, card)
    for path in float_osc_paths(ktt):
        path_launches[path] = partitions[path][4]["chain_kernel"]
    lap(phase_float_osc_card_vs_cpu, torch, np, ktt, dev, card)
    path_launches.update(lap(phase_noise_delay_slices, torch, ktt, dev, card))
    lap(phase_fdn_galactic, torch, np, ktt, dev, card)
    lap(phase_galactic_chain, torch, np, ktt, dev, card)
    lap(phase_pool_envelope_bank, torch, np, ktt, dev, card)
    lap(phase_modal_bells, torch, np, ktt, dev, card)
    lap(phase_detuned_banks, torch, np, ktt, dev, card)
    lap(phase_vmap_banks, torch, np, ktt, dev, card)
    lap(phase_buffers, torch, np, ktt, dev, card)
    live_rows = lap(phase_live, torch, np, ktt, dev, card)
    lap(phase_program_cache, torch, np, ktt, dev, card)
    lap(phase_mesh, torch, np, ktt, dev, card)
    user_rows, organ_cpu = lap(phase_extensions, torch, np, ktt, dev, card)
    lowered_rows = lap(phase_lowered, torch, np, ktt, dev, card, organ_cpu)
    example_rows = lap(phase_examples, torch, np, ktt, dev, card)
    print(f"slices: {time.perf_counter() - t0:.1f} s")

    # -- timings at the main path's shape ---------------------------------
    t0 = time.perf_counter()
    table = []
    for kind in ("sine", "fm", "sub", "wt"):
        bank, state, launches, _ = results[kind]
        ms, plain_ms, bound_ms, bound_by = phase_timings(torch, ktt, kind, bank, state, card)
        name = kernel_module(kind).KERNEL
        table.append(kernel_row(name, launches, errs[name], ms, plain_ms, bound_ms,
                                bound_by))
    # the generic harness: one row per body, each with its slice's launches
    for body in ("sine", "fm", "subtractive", "additive", "envelope", "modal"):
        kind = f"generic-{body}"
        bank, state, launches, _ = results[kind]
        if body in ("envelope", "modal"):
            row = phase_family_timings(torch, ktt, body, bank, state, card)
        else:
            row = phase_timings(torch, ktt, kind, bank, state, card)
        table.append(kernel_row("generic_bank", launches, body_errs[body], *row,
                                label=f"generic_bank:{body}"))
    for name, row in phase_stage_timings(torch, np, ktt, dev, card).items():
        table.append(kernel_row(name, stage_launches[name], errs[name], *row))
    # the chain kernel on the subtractive slice's two chain paths and the
    # param-sweep slice's two: one row each, with that path's launches and
    # its program's measured error
    paths = {n: b for n, b in chain_paths(ktt).items() if n in path_launches}
    paths.update(float_osc_paths(ktt))
    paths.update({n: b for n, b in noise_delay_paths(ktt).items() if n in path_launches})
    for path, row in phase_chain_path_timings(torch, ktt, dev, card, paths).items():
        table.append(kernel_row("chain_kernel", path_launches[path], path_errs[path],
                                *row, label=f"chain_kernel:{path}"))
    table.extend(live_rows.values())
    table.extend(user_rows)
    table.extend(lowered_rows)
    table.extend(example_rows)
    print(f"timings: {time.perf_counter() - t0:.1f} s; "
          f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tetra_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):

1. header: the card's name and power limit, torch/CUDA/nvcc versions and
   the build time of the kernels (nvcc, from tetra_tpu_torch/csrc/);
2. kernels: K1 (agc_fll_rrc), K2 (mm_costas), K3 (fold_dft_resample) and
   K4 (fold_dft) against their plain PyTorch versions on the same inputs at
   the main path's shapes (C = 256 channels, T = 4608; n_ch = 256,
   t50 = 6400), with their median times;
3. slice: the wideband fleet receiver TetraReceiver(wideband=256,
   t50=6400, fleet=True, wb_k=8, device="cuda") over ~6 s of synthesized
   8-cell air (5 superblocks of staged windows); gates: > 90% of channels
   locked, crc_ok > 3 x crc_fail after warm-up, the cells' MCC/MNC
   decoded, every kernel launched, and the typed FEC's trellis kernel
   (csrc/fec_trellis.cu) launched once or twice a timed superblock (it
   prints the launches and fec.trellis_rows against fec.rows, from the
   program's spans).  The kernel's rows then come from the slice's
   trellis inputs: the SB1/NDB pass (~37,000 rows x 144 steps), 4 times
   that, and a 288-step pass of SCHF_TRELLIS_ROWS rows, each
   bit for bit against its plain twin rx/viterbi._viterbi on the card,
   with both times and the kernel's bound;
3b. slice_pipeline (run after slice, printed after the profiler windows):
   the same staged air through TetraReceiver(..., link_profile="pcie")
   (superblocks double-buffered, the step on the receiver's side CUDA
   stream, the output through pinned buffers; fleet workers on every
   core), its tunnel twin and a tunnel receiver with workers on every
   core, taking turns superblock by superblock.  Gates after
   flush_wideband():
   locks, CRC tallies, display, lock losses and the engine's state blob
   equal to the tunnel twin's on 256/256 channels, the slice's three
   decode gates, K1-K4 launched 8 times a superblock by each, the pcie
   receiver's all on its side stream (its FEC's trellis kernels on the
   caller's, where the FEC runs).  It prints per receiver the
   superblock wall (mean, min, max), host-clock stages, rt_margin and
   IQ->PDU latency (sb_air x (1 + pipelined) + wall, as
   scripts/bench_e2e.py computes it), of which the typed FEC; and, from
   a profiler window at the end,
   the card's busy share under the pcie and tunnel receivers;
4. slice_nonfleet: the per-channel receiver as the CLI builds it,
   TetraReceiver(wideband=256, t50=6400, events=False, device="cuda")
   (device SYNC acquisition on by default at 256 channels), fed host cf32
   chunks of the first 3.6 s of the same air, one 128 ms cycle a call:
   K3, K1 and K2 in its full form on the card each cycle, host burst sync,
   one FEC pass on the card, the native MAC dispatch.  It prints the rate,
   rt_margin, wall ms per cycle and host-clock stage times per cycle over
   the cycles after a 1.5 s warm-up; gates: the slice's three, > 90% of
   channels passing quality_ok, a constellation on every locked channel
   (K2's full form), K1-K4 launched and the device acquisition used.
5. slice_voice: the same receiver and feed on 3.6 s of air whose 8 cells
   carry voice on timeslot 2 with stolen slots of both kinds, cells 4-7
   TEA1-encrypted (tx.wideband.voice_cell_air; the keystore is written to
   a temporary file): one VoicePipeline on carriers 0-7 (one per cell),
   carriers 4-7 with one CryptoState from the keystore on the upper MAC
   and the pipeline, and their event logs on.  Gates: slice_nonfleet's;
   on every carrier >= 80% of the voice slots after warm-up decoded (not
   counting both-halves steals); every frame handed to the codec without
   a bad-frame flag equal to the sent one (on encrypted carriers after
   decryption, once the receiver has both SYSINFO arms, and different
   from it on air; a stolen half's frame on the encrypted carriers XORed
   with the slot's keystream bits 137-273 as the pipeline's cipher state
   made them, as the fixture sends it clear where the pipeline decrypts
   it); bad frames <= 2%; a stolen-half decode that matched;
   480 samples a decoded slot, equal to a fresh AcelpDecoder fed the same
   frames; decrypted SDUs on carriers 4-7; the decode's tensors on the
   card.  Its line (printed after the profiler windows, which also count
   the device ops of one decode_slot call) carries the rate, rt_margin
   and stage times beside slice_nonfleet's, and ms per pipeline call
   split into channel decode and ACELP.
6. slice_modes: the CLI's --wideband N --demod ff/exact host path on the
   same 256-carrier air scaled to full scale: channelizer.channelize (K4
   on the card, exactly one launch over the whole capture, ~180,000 rows,
   its output held against fold_dft_plain on the same rows at K4's limit)
   and resample_50_to_36,
   then TetraReceiver(256, mode=m, events=False) fed 4096-sample blocks,
   "ff" over 3.6 s and "exact" (the per-sample parity chain, a few
   hundred thousand small device ops a block) over the first 2.0 s, 1.5 s
   of warm-up each.  Gates per mode: > 90% of channels locked and > 90%
   showing their own cell's MCC/MNC with all 8 cells decoded, crc_ok >
   3 x crc_fail after warm-up, > 90% passing quality_ok, K4 launched by
   channelize and no kernel launched by the receiver.  It prints ms per
   block split into demod, burst sync, FEC and MAC, rt_margin, and the
   channelize and resample times.  Then both chains, from the warm state,
   run one block on the card and on the CPU: dibits and valid identical
   on >= 99% of channels, floats within TOL_MODES_FLOAT on those (a
   share within the tolerance and a limit on every slot), and the exact
   chain's float check must fail a control run on the block rounded to
   float16.  Then
   the CLI round trip as subprocesses on the card: tetra_tx writes a
   1-channel capture and an 8-carrier --wideband capture (cells on
   carriers 0, 3, 5; K4's matrix-DFT kernel, which 8 channels take, is
   held against its plain version on that capture's rows); tetra_rx
   decodes the first with --demod fast, ff
   and exact and the second with --demod ff; each must lock and show the
   cell's MCC/MNC in its summary JSON.  The two captures are written
   together, and the four decodes run together.  The exact chain's
   device ops over 1024 samples are counted in a profiler window at the
   end.
7. slice_pool (run after slice_nonfleet): the same receiver with its MAC
   in POOL_WORKERS CPU worker processes, TetraReceiver(wideband=256,
   t50=6400, events=False, mac_workers=4) (the CLI's --mac-workers 4),
   over slice_nonfleet's air and warm-up: its decode gates, K1-K4
   launched, and per channel display(c) and crc_counts(c) equal to
   slice_nonfleet's in-process receiver's.  Then voice: voice_cell_air at
   16 carriers through a 4-worker pool with voice=True and a keystore (the
   workers decode speech on the CPU) against the same receiver in process
   with a VoicePipeline on the card per carrier, fed in lockstep: each
   cycle's pool.take_audio() equal to the in-process PCM in the pool's
   batch order, and equal decrypted-SDU counts per carrier.  It prints
   stage ms per cycle (the parent's, and the wait for the workers'
   replies), the workers' start-up time and K1-K4's launches per cycle.
8. slice_mesh: (a) in this process, a 1x1 (host, chip) mesh (one gloo
   rank): parallel.mesh.sharded_wideband_superblock_step at n_ch = 256,
   wb_k = 8, t50 = 6400 over 4 superblocks of the fleet slice's air (K4
   over the band, the resample kernel alone, K1, K2 lean; launches
   counted over those steps alone), its packed words equal to
   rx.receiver._wideband_step_scan's on the same windows (rows [:-1];
   the dist-sum row within 2e-3 relative) and its all-reduced health
   equal to its rows' sums; (b) the multihost launcher's one-card
   rehearsal as a subprocess (python -m tetra_tpu_torch.apps.multihost
   --hosts 2 --chips 1 --channels 256 --selftest --backend gloo: two gloo
   ranks on this card), which must print SELFTEST PASS for both hosts;
   it prints MS/s per host and the wall time.  slice_pool and slice_mesh
   print their wall time (phase_s).
9. slice_marginal (after slice_mesh): 256 carriers at marginal SNR, every
   8th dropping out and coming back as another cell (phase_slice_marginal
   has the air, the three receivers and the gates): fleet vs per-channel
   state, no false adopted cell, the handover carriers relocked on their
   new cell, own-cell shares per SNR band, K1-K4 launched on every
   superblock and cycle, and one superblock card vs CPU under the
   marginal-SNR rule of k2_check.  It prints the locked and own-cell
   share per SNR band, the CRC tallies, the handover relock times,
   rt_margin of each receiver and the stage and phase times.
10. slice_wide (after slice_marginal; `python3 chip_smoke.py slice_wide`
   runs it alone after the build, its kernels line as "kernels_wide" and
   its last line {"phase": "slice_wide", "passed": true}, not the
   contract's): the JAX round's wide configurations
   (WIDE_CONFIGS) through TetraReceiver(wideband=N, t50=6400, fleet=True,
   wb_k=K): 1024 carriers at wb_k 8, then 512 at wb_k 16, each on
   tx.wideband.cell_air_device's air (cell_air's recipe built on the
   card through assemble_wideband); staged superblocks after a 1.5 s warm-up, then (1024) one
   superblock of host cf32 through process_wideband.  Gates: > 90% locked,
   crc_ok > 3 x crc_fail after warm-up (after a flush), > 90% on their own
   cell, > 90% quality_ok, K1-K4 launched wb_k times a superblock.  It
   prints per receiver slice_pipeline's stage breakdown, rt_margin,
   wideband Msamples/s, IQ->PDU latency and the busy share over one
   profiled superblock; K3 and K4 against their plain versions at each
   n_ch; the demod at bench.py's width (2048 channels x 4608, 8 blocks a
   call: demod_blocks from host IQ and the lean chain on the card), K1 and
   K2 against their plain versions at 1024 and 2048 channels (K1 within
   TOL_K1_MF_WIDE, K2 under k2_check's marginal-SNR rule); and ptxas's
   registers and spills of K4's FFT kernels at 512 and 1024.  Its kernel
   rows print as `kernel_wide:` lines, and the kernels line carries
   launches_wide (slice_wide's receivers) and each kernel's rows at the
   new shapes.
11. slice_voice_fleet (after slice_voice): the fleet receiver with its
   voice monitor, TetraReceiver(wideband=256, t50=6400, fleet=True,
   wb_k=8, voice=True, keystore=...), on 6 s of voice_cell_air's air at
   256 carriers (FLEET_VOICE_SECONDS; voice on timeslot 2, steals of both
   kinds, cells 4-7 TEA1 with the keys held), staged superblocks after a
   1.5 s warm-up and take_voice() after each.  Gates: the fleet slice's
   three; the speech trellis kernel launched once a timed superblock,
   with one voice block each; every delivered row a voice slot or
   surviving half the air sent on its carrier's cell, once, on timeslot
   2, DECRYPTED on cells 4-7 and CLEAR elsewhere; its frames without a
   bad-frame flag the sent plaintext (a half on cells 4-7, which the
   fixture sends clear, XORed with the sender's keystream bits 137-273
   again, and different from it as delivered); no voice row the air sent
   missing between a carrier's first and last delivered row; voice on >
   90% of the carriers; bad frames <= 2%; the PCM of every call on
   carriers 0-15 equal to a fresh AcelpDecoder's; and the kernel bit for
   bit against its plain version on the last superblock's rows (~5,000
   rows x 112 steps at one voice timeslot).  It prints rt_margin, the
   rows, halves and bad frames, and the kernel's row (`kernel:`, with
   its ms, plain_ms and bound), which the kernels line carries with its
   launches.  The monitor's ACELP synthesis runs on the card
   (csrc/acelp_synth.cu, launched once a timed superblock, a gate), so
   the replayed PCM holds the kernel to the host codec; then the
   kernel's own row, `acelp_synth`, at the voice cell's shape (12,720
   items of 768 calls, three batches carried over): PCM against the host
   codec's AcelpBank, max_abs_err 0 or the phase fails; the kernel's ms
   (events), the card bank's whole call (call_ms: upload, launch, fetch
   into pinned memory, copy out), the host bank's (plain_ms, on cores - 1
   threads) and the bound of the longest call's serial chain.

A line `timing:` before the kernel lines gives each phase's wall time
(the profiler windows at the end included) and the total.

K3's row also carries its second kernel, the resample, timed alone on
K4's output (resample_ms, 9 runs of 20 launches with min-max, and
resample_device_ms) beside its own bound and its error against
channelizer._resample_stream_block_fm;
Every kernel row carries device_ms, the sum of its kernels' device rows
in one torch.profiler window over 20 launches, divided by 20 (K2's row in
its lean form, with full_ms, full_device_ms and full_bound_ms for the
full form the per-channel receiver launches); K3's and K4's rows also
carry host_ms, the wrapper's host time per call (an event time above
device_ms is host_ms showing through).  The profiler windows run after the slice,
and the kernel lines are printed after them: launches right after a
profiler session take longer on the host.

Each kernel row carries its bound on the card (bound_ms: the larger of its
bytes over the HBM rate and its operations over the FP32 rate, from this
run's shapes; bound_by says which), its launches per superblock on the
fleet slice, its launches on slice_pipeline's pcie receiver
(launches_pipeline), its launches on the per-channel slice
(launches_nonfleet, one per 128 ms cycle), its launches on slice_modes'
in-process path (launches_modes: K4 from channelize only), on
slice_pool (launches_pool), on slice_mesh (a) (launches_mesh: K3's
row counts its second kernel, the resample, which the mesh launches
alone after K4) and on slice_marginal's three receivers
(launches_marginal), and
library_ms: the time of PyTorch library calls computing the same function
where they exist, else null.  For K4 two such yardsticks are
timed, each a fold then one torch.fft.fft and the flip: the fold as an
einsum over a strided view of the input, and as dilated depthwise conv1d
with cuDNN's algorithm chosen by timing; library_ms is the faster, and
the row keeps both with their spread.  K3's yardstick is that faster one
followed by the plain resampler (one einsum against its superblock
matrix), with its spread.  The port never calls them.

The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}.  Needs a CUDA device and exits
non-zero without one.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tetra_tpu_torch import convert, exact_float32
from tetra_tpu_torch import params as P
from tetra_tpu_torch import spans as SPANS
from tetra_tpu_torch.apps.tetra_rx import load_iq
from tetra_tpu_torch.crypto.state import CryptoState, KeyStore
from tetra_tpu_torch.ops import _build
from tetra_tpu_torch.ops import acelp_kernel as AK
from tetra_tpu_torch.ops import chan_kernel as CK
from tetra_tpu_torch.ops import demod_kernel as DK
from tetra_tpu_torch.ops import fec_trellis as FT
from tetra_tpu_torch.ops import mm_kernel as MK
from tetra_tpu_torch.parallel import channelizer as CH
from tetra_tpu_torch.rx import demod_fast as DF
from tetra_tpu_torch.rx import fec as FEC
from tetra_tpu_torch.rx import lower_mac as LM
from tetra_tpu_torch.rx import receiver as R
from tetra_tpu_torch.rx import viterbi as V
from tetra_tpu_torch.rx.hostpool import MacPool
from tetra_tpu_torch.rx.receiver import TetraReceiver
from tetra_tpu_torch.ops import speech_kernel as SK
from tetra_tpu_torch.rx.tdma import TdmaTime
from tetra_tpu_torch.tx.wideband import (MARGINAL_SNR_DB, _cell_config,
                                         _tx_crypto, cell_air,
                                         cell_air_device, cell_keystore,
                                         heterogeneous_fleet_iq,
                                         staged_windows, voice_cell_air)
from tetra_tpu_torch.voice import channel as VCH
from tetra_tpu_torch.voice import monitor as VM
from tetra_tpu_torch.voice import speech_batch as SB
from tetra_tpu_torch.voice.acelp import AcelpBank, AcelpDecoder
from tetra_tpu_torch.voice.pipeline import VoicePipeline

C_DEMOD, T_DEMOD = 256, 4608          # demod shapes of the main path
N_CH, T50 = 256, 6400                 # front-end shapes of the main path
WB_K = 8
WARM_BLOCKS = 9                       # demod blocks before the K1/K2 check
AIR_SECONDS = 6.0
N_CELLS = 8
NONFLEET_SECONDS = 3.6                # air the per-channel slice is fed
WARM_SECONDS = 1.5                    # FLL pull-in + scrambling acquisition
ENCRYPTED = (4, 5, 6, 7)              # TEA1 cells of the voice slice
VOICE_TS = 2                          # the voice slice's traffic timeslot
MIN_VOICE_SHARE = 0.8                 # voice slots decoded after warm-up
MAX_BAD_SHARE = 0.02                  # bad frames among decoded slots
FLEET_VOICE_SECONDS = 6.0             # air the fleet voice slice is fed
REPLAY_CARRIERS = 16                  # carriers whose calls' PCM is replayed
ACELP_ITEMS = 12_720        # the voice cell's synthesis items a superblock
ACELP_BATCHES = 3           # batches the ACELP row holds to the host codec
SYNTH_CHAIN_OPS = 4 * 60 * 10   # synthesis filter's dependent ops a frame
FP32_LATENCY_CYCLES = 4     # an FP32 add's latency on Hopper
SM_CLOCK_HZ = 1.98e9        # H100 SXM boost clock
MODES_SECONDS = {"ff": 3.6, "exact": 2.0}   # air each mode's receiver is fed
MODES_BLOCK = 4096                    # the CLI's --block
TOL_MODES_CHANNELS = 0.99  # card vs CPU: share of identical dibits/valid
# card vs CPU, on the channels with identical dibits/valid: (tolerance,
# share of their valid slots' symbols and dist within it, limit on every
# slot).  ff: all within 1e-3 (the CPU tests read <= 2.3e-4 against JAX:
# a symbol position p ~ 4600 carries its fraction at float32's 4.9e-4
# ulp).  exact: >= 99% within 1e-4 and all within 2e-2: where
# floor(mu * 128) lands on the other side of an integer the interpolator
# takes the adjacent polyphase row (a step of up to ~1e-2) and the timing
# loop carries it on; tests/test_torch_demod_exact.py holds every slot to
# the same 2e-2.  The H100 (700 W) read 0.9973 within 1e-4 and 9.8e-3 at
# most; the control below (the block rounded to float16, TF32's 10-bit
# mantissa, on the CPU) read 0.63-0.66 on 8 channels of the tests' air.
TOL_MODES_FLOAT = {"ff": (1e-3, 1.0, 1e-3), "exact": (1e-4, 0.99, 2e-2)}
# modes whose float check must tell the float16 control apart (ff's 1e-3
# is wider than what float16 inputs move its symbols: <= 4.9e-4)
CONTROL_FAILS = ("exact",)
CLI_SLOTS = 96             # the round trip's 1-channel capture (1.36 s)
EXACT_PROFILED = 1024      # samples of the exact chain's profiler window
POOL_WORKERS = 4           # slice_pool's MAC worker processes
POOL_VOICE_CARRIERS = 8    # slice_pool's voice run: one B = 1 pipeline a
POOL_VOICE_SECONDS = 2.4   # carrier on the card for the comparator
MESH_SUPERBLOCKS = 4       # slice_mesh (a): 4 x 8 cycles of the air
PIPE_PROFILED = 2          # slice_pipeline: superblocks fed again, profiled
SCHF_TRELLIS_ROWS = 20480  # kernel row at 288 steps: a row a slot of 256
                           # carriers over 8 cycles, +10%, in 1024s
MARGINAL_SECONDS = 5.0     # slice_marginal's air (tx.wideband.marginal_air)
MARGINAL_DROPOUT_AT = 2.0  # its handover carriers go silent, for 0.5 s
MARGINAL_CARD_VS_CPU_AT = 3          # superblock (~3 s in) held to the CPU
# slice_marginal: least share of the carriers in an SNR band (dB, bounds
# included, handover carriers apart) whose adopted cell is their own at
# the end.  The wideband chain churns at these SNRs (lock losses, missed
# SYNC bursts), in the reference as in the port, so no carrier is
# required to lock; tests/torch_marginal_readings.py (the fleet
# receiver at this phase's shapes, 32 carriers, CPU, seeds 0 and 1) read
# 25/26 carriers at 10-12 dB and 25/32 at 7.5-10 dB, no false cell, and
# 8/8 handover carriers locked on their new cell.
MARGINAL_OWN_SHARE = {(10.0, 12.0): 0.7, (7.5, 10.0): 0.5}
# the state a block's decode sets (rx/parity.channel_mismatches' names):
# where a superblock's adoption re-decode passes rows that failed in the
# per-cycle paths, or the reverse, those rows are dispatched in one and
# not the other
DECODE_FIELDS = {"crc_counts", "mac_flags", "display"}

# limits of kernel vs plain on identical inputs (float32, different
# summation orders and cosf/sinf/rsqrtf vs the CPU-style library calls)
TOL_K1_MF = 2e-4          # matched filter, absolute (signal ~ AGC setpoint 1)
TOL_K1_STATE = 1e-4       # gain (relative), phase, freq
TOL_K2_CHANNELS = 0.99    # share of channels with identical dibits/valid
# K2 symbols and |sin| dist on the slots both call valid: within
# TOL_K2_CLOSE on every channel, except a channel whose loop state steps
# apart at a switch of the rail-gated Costas leak (on while |cfreq| >
# leak_th = 0.3 clim; switching changes the next update by 5% of cfreq):
# a last-bit difference in cfreq there takes the two runs to different
# sides of the switch.  Such a channel must, in one of the K2_LEAK_LOOKBACK
# groups before the first group where it differs by more than
# TOL_K2_CLOSE, show the plain run's |cfreq| within K2_LEAK_EPS of
# leak_th (before any switch the runs' cfreq differ by ~1e-7 per group:
# cb_g ~ 1e-4 times a 64-symbol sum of ~2e-5 differences), and stay within
# TOL_K2_MAX (the step is bounded and decays).
TOL_K2_CLOSE = 1e-3
TOL_K2_MAX = 0.05
K2_LEAK_EPS = 1e-5
K2_LEAK_LOOKBACK = 3
# slice_marginal (7.5-12 dB, card vs CPU from one state, K2 on the same
# K1 output): samples near an axis, where sgn() decides the quadrant, the
# Costas error or the timing error, are loop switches too (k2_check's
# axis_eps), and a leak switch there goes on to flip such symbols.
# tests/torch_marginal_readings.py --card-vs-cpu --seeds 11 12 13
# (3 seeds x 3 warm states x 8 cycles, NVIDIA H100 80GB HBM3, 700 W)
# read 172 channel-cycles that differ, each after a leak switch (48,
# |cfreq| within 9.8e-6 of the threshold) or a sample within 5.2e-5 of
# an axis (124); at most 6 of 256 channels a cycle.
K2_AXIS_EPS = 1e-4
K2_AXIS_SHARE = 0.05
# the chain (K3, K1, K2) card vs CPU at marginal SNR: K1's mf differs by
# up to 7.8e-4 there, so K2's inputs differ and switches come at any
# distance; the same readings: dibits/valid identical on 0.9805-1 of the
# channels a cycle
TOL_MARGINAL_CHAIN_CHANNELS = 0.95
TOL_FRONT_REL = 1e-4      # K3/K4 max error over the output's RMS
# slice_wide: the JAX round's wide configurations (carriers, wb_k, timed
# staged superblocks, superblocks fed as host cf32 after them): 1024
# carriers (the 380-400 MHz band in one receiver; the JAX round ran two
# 512-carrier receivers, scripts/bench_e2e.py:153-163) and 512 carriers
# at wb_k 16 (BENCH_DETAIL.md:95)
WIDE_CONFIGS = ((1024, 8, 2, 1), (512, 16, 2, 0))
WIDE_DEMOD_C = 2048       # bench.py's flagship width (bench.py:201-203)
WIDE_DEMOD_K = 8          # blocks a timed call
WIDE_DEMOD_RUNS = 5       # timed calls, median
WIDE_K12_C = (1024, 2048)  # K1/K2 against their plain versions
# K1 card vs plain at WIDE_K12_C from a warm state (25 dB fleet): the
# 256-channel limits (TOL_K1_MF, TOL_K1_STATE) hold along one warm-up
# trajectory only (ROADMAP Queue 3); at 1024 and 2048 channels
# tests/torch_wide_readings.py --seeds 2 3 4 (3 warm states; NVIDIA H100
# 80GB HBM3, 700 W) read mf 2.05e-4, 2.44e-4, 2.20e-4 and state 1.39e-4,
# 1.87e-4, 9.2e-5 (the largest errors lie in the first 1024 channels):
# the limits are twice the largest reading.  K2 there is held by
# k2_check's marginal-SNR rule (axis_eps): at this width a few channels
# part after an axis switch at 25 dB too (the same readings: 2-3 of 2048
# differ from group 2-26 on without a leak switch before it)
TOL_K1_MF_WIDE = 5e-4
TOL_K1_STATE_WIDE = 4e-4

# H100 SXM published peaks (NVIDIA data sheet) for the bounds: HBM3 rate,
# and FP32 outside the tensor cores (no kernel here uses them)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
F32 = 4

REPLACES = {
    "K1 agc_fll_rrc": "tetra_tpu/ops/demod_pallas.py:328",
    "K2 mm_costas": "tetra_tpu/ops/mm_pallas.py:628",
    "K3 fold_dft_resample": "tetra_tpu/ops/chan_pallas.py:176",
    "K4 fold_dft": "tetra_tpu/ops/chan_pallas.py:218",
    "speech_trellis": "tetra_tpu/voice/channel.py:420",
    "fec_trellis": "none (tetra_tpu/rx/viterbi.py:99 _viterbi is an XLA "
                   "scan)",
    "acelp_synth": "none (tetra_tpu/voice/acelp.py: the host C++ codec)",
}
SOURCES = {
    "K1 agc_fll_rrc": "tetra_tpu_torch/csrc/agc_fll_rrc.cu",
    "K2 mm_costas": "tetra_tpu_torch/csrc/mm_costas.cu",
    "K3 fold_dft_resample": "tetra_tpu_torch/csrc/chan.cu",
    "K4 fold_dft": "tetra_tpu_torch/csrc/chan.cu",
    "speech_trellis": "tetra_tpu_torch/csrc/speech_trellis.cu",
    "fec_trellis": "tetra_tpu_torch/csrc/fec_trellis.cu",
    "acelp_synth": "tetra_tpu_torch/csrc/acelp_synth.cu",
}


def _device_ms(event) -> float:
    """A profiler row's device ms (self_device_time_total, or
    self_cuda_time_total on an older torch)."""
    us = getattr(event, "self_device_time_total", None)
    if us is None:
        us = event.self_cuda_time_total
    return us / 1e3


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def nvcc_version() -> str:
    res = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip().splitlines()[-1]


def batch_ms(fn, launches: int, batches: int) -> list[float]:
    """Device time per call of fn, one value per batch: CUDA events around
    `launches` calls in a row (the card stays busy, so the host's own time
    between calls is hidden), after 0.3 s of calls that bring the card's
    clocks up (it idles at a few hundred MHz)."""
    t0 = time.perf_counter()
    fn()
    while time.perf_counter() - t0 < 0.3:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return times


def host_ms(fn, launches: int = 20, batches: int = 9) -> float:
    """Host time per call of fn: the host clock around `launches` calls in
    a row that only queue work (the card is synchronized before each
    run), median of `batches` runs.  Above the device time, it sets the
    event time of batch_ms."""
    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / launches)
    torch.cuda.synchronize()
    return float(np.median(times))


def median_ms(fn, launches: int, batches: int = 5) -> float:
    return float(np.median(batch_ms(fn, launches, batches)))


def maxerr(a, b) -> float:
    return float((a - b).abs().max())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes (each input read once,
    each output written once) over the HBM rate, or operations over the
    FP32 rate, whichever is larger."""
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return dict(bound_ms=max(tb, to) * 1e3,
                bound_by="bytes" if tb >= to else "operations",
                bytes=int(n_bytes), ops=int(n_ops))


def k1_work(T: int, C: int, Kd: int) -> dict:
    """K1 per (sample, channel): gain 2, |y| and its sum 5, rotator ramp
    24, derotation 6, RRC 2 x 65 FMAs (4 x 65 ops), band edge on Kd of
    every 64 samples 8 x 65 FMAs."""
    ntap = DK.HIST + 1
    per = 2 + 5 + 24 + 6 + 4 * ntap + (Kd / DF.K_SAMP) * 16 * ntap
    n_bytes = F32 * (4 * T * C + 4 * DK.HIST * C + 6 * C + 5 * ntap) + 4 * Kd
    return bound(n_bytes, per * T * C)


def k2_work(T: int, C: int, S: int, emit_syms: bool) -> dict:
    """K2 per symbol slot: 8 taps x 2 degree-5 Horner (160), the 8-tap
    value and derivative dots (64), timing error 4, rotator ramp 24,
    derotation 6, Costas error 4, |sin| dist 9."""
    per = 160 + 64 + 4 + 24 + 6 + 4 + 9
    outs = (5 if emit_syms else 3) * S * C
    n_bytes = F32 * (2 * T * C + 2 * 7 * C + 16 * C + outs + 96)
    return bound(n_bytes, per * S * C)


def k4_work(rows: int, n_ch: int, n_s: int) -> dict:
    """K4's function at its least work, per 50 kHz frame: the fold, n_ch
    branches x n_s/2 taps x 2 (re, im) FMAs; a length-n_ch complex FFT,
    5 n_ch log2(n_ch) operations (the kernel's algorithm at a power-of-two
    n_ch); the flip 2 n_ch.  Bytes: z and the fold weights in, the frames
    out."""
    n_out = rows - (n_s - 1)
    hop = n_ch // 2
    fft = 5 * n_ch * int(np.log2(n_ch))
    ops = n_out * (n_ch * (n_s // 2) * 4 + fft + 2 * n_ch)
    n_bytes = F32 * (2 * rows * hop + n_s * hop + 2 * n_out * n_ch)
    return bound(n_bytes, ops)


def k3_work(rows: int, n_ch: int, n_s: int, t36: int) -> dict:
    """K3 = K4, then the 24-tap 18/25 resample (2 x 24 FMAs per output);
    its bytes: z, fold weights, resample taps and offsets, and history in,
    the 36 kHz rows and history out (the 50 kHz rows between the two
    kernels are neither)."""
    k4 = k4_work(rows, n_ch, n_s)
    ntap = CH.RS_TAPS_PER_PHASE
    ops = k4["ops"] + t36 * n_ch * 2 * 2 * ntap
    n_bytes = F32 * (2 * rows * (n_ch // 2) + n_s * (n_ch // 2)
                     + 18 * ntap + 18 + 4 * (ntap - 1) * n_ch
                     + 2 * t36 * n_ch)
    return bound(n_bytes, ops)


def resample_work(t_in: int, C: int, t36: int) -> dict:
    """The resample alone (K3's second kernel): 2 x 24 FMAs per output;
    bytes: y, history, taps and offsets in, the 36 kHz rows and the next
    block's history out."""
    ntap = CH.RS_TAPS_PER_PHASE
    n_bytes = F32 * (2 * t_in * C + 4 * (ntap - 1) * C + 18 * ntap + 18
                     + 2 * t36 * C)
    return bound(n_bytes, t36 * C * 2 * 2 * ntap)


def device_ms(fn, launches: int = 20) -> tuple[float | None, dict]:
    """Device time per call of fn: the sum of the device rows of one
    torch.profiler window over `launches` calls, over `launches`; and the
    same per kernel name.  (None, {}) if the profiler saw no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    per = {e.key: _device_ms(e) / launches for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and _device_ms(e) > 0}
    return (sum(per.values()) if per else None), per


def _fft_flip(fr, fi, n_ch: int):
    """K4's DFT and flip after a fold: one torch.fft.fft over the channel
    axis, then (-1)^(m k)."""
    y = torch.fft.fft(torch.complex(fr, fi), dim=-1)
    m = torch.arange(fr.shape[0], device=fr.device)
    k = torch.arange(n_ch, device=fr.device)
    flip = 1.0 - 2.0 * ((m[:, None] * k[None, :]) % 2)
    return y.real * flip, y.imag * flip


def k4_library_einsum(zr, zi, n_ch: int):
    """K4's function by PyTorch library calls, a yardstick only: the fold
    of each branch half d as one einsum over the strided view
    z.unfold(0, n_s, 1)[..., d::2] (frame m, column c, tap j reads row
    m + 2j + d), then torch.fft.fft and the flip."""
    F = CK._tables(n_ch, zr.device)[0]                   # (n_s, hop)
    n_s = F.shape[0]

    def fold(z):
        win = z.unfold(0, n_s, 1)                         # (n_out, hop, n_s)
        return torch.cat([torch.einsum("mcj,jc->mc", win[..., d::2],
                                       F[d::2]) for d in (0, 1)], dim=1)

    return _fft_flip(fold(zr), fold(zi), n_ch)


def k4_library_conv(zr, zi, n_ch: int):
    """The same yardstick with the fold as two dilated depthwise conv1d
    per component (branch halves d = 0, 1); cuDNN's algorithm is chosen by
    timing (benchmark mode), not by its heuristics."""
    F = CK._tables(n_ch, zr.device)[0]
    n_s, hop = F.shape
    n_out = zr.shape[0] - (n_s - 1)

    def fold(z):
        x = z.T[None]                                     # (1, hop, rows)
        halves = [torch.nn.functional.conv1d(
            x[..., d:d + n_out + n_s - 2], F[d::2].T[:, None, :],
            dilation=2, groups=hop)[0, :, :n_out] for d in (0, 1)]
        return torch.cat(halves, dim=0).T                 # (n_out, n_ch)

    with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                    deterministic=False, allow_tf32=False):
        return _fft_flip(fold(zr), fold(zi), n_ch)


K4_LIBRARY = {"einsum fold + torch.fft.fft + flip": k4_library_einsum,
              "conv1d fold + torch.fft.fft + flip": k4_library_conv}


def k3_library(k4_label: str, zr, zi, hr, hi, n_ch: int, t36: int):
    """K3's function by PyTorch library calls, a yardstick only: the K4
    yardstick k4_label, then the resample as one einsum against the
    superblock matrix (channelizer._resample_stream_block_fm)."""
    yr, yi = K4_LIBRARY[k4_label](zr, zi, n_ch)
    return CH._resample_stream_block_fm(yr, yi, hr, hi, t36)


def warm_demod(dev, xr: np.ndarray, xi: np.ndarray, n_warm: int):
    """The kernel chain's state after blocks xr/xi[:n_warm] ((k, C, T)
    host float32, lean form)."""
    state = DF.demod_init(xr.shape[1], dev)
    n_chunks = DF.n_chunks_for(xr.shape[2])
    for j in range(n_warm):
        state, _ = DF._demod_block_impl(
            state, torch.from_numpy(xr[j]).to(dev),
            torch.from_numpy(xi[j]).to(dev), n_chunks, tc_out=True)
    return state


def demod_rows(state, x_r, x_i, tol_mf: float = TOL_K1_MF,
               what: str = "K2", gate=check,
               tol_state: float = TOL_K1_STATE,
               axis_eps: float | None = None) -> tuple[list[dict], list]:
    """K1 and K2 against their plain versions on one block x_r/x_i ((T, C)
    on the card) from the demod state `state`: K1's mf within tol_mf and
    its state within tol_state, then K2 on K1's output by k2_check (with
    axis_eps, its marginal-SNR rule); K2
    timed in its lean form (the fleet's) and its full form (the
    per-channel receiver's).  Returns the rows and the profiler jobs
    (row, key, fn) that phase_device_times runs after every timed
    phase."""
    T, C = x_r.shape
    n_chunks = DF.n_chunks_for(T)
    args1 = (x_r, x_i, state.agc_gain, state.fll_phase, state.fll_freq,
             state.fll_hist_re.T.contiguous(),
             state.fll_hist_im.T.contiguous())
    k1 = DK.agc_fll_rrc(*args1)
    p1 = DK.agc_fll_rrc_plain(*args1)
    torch.cuda.synchronize()
    err_mf = max(maxerr(k1[0], p1[0]), maxerr(k1[1], p1[1]))
    err_gain = maxerr(k1[2] / p1[2], torch.ones_like(p1[2]))
    err_st = max(err_gain, maxerr(k1[3], p1[3]), maxerr(k1[4], p1[4]))
    gate(err_mf <= tol_mf, f"K1 at C={C}: mf error {err_mf} > {tol_mf}")
    gate(err_st <= tol_state, f"K1 at C={C}: state error {err_st}")
    rows = [dict(name="K1 agc_fll_rrc", channels=C, max_abs_err=err_mf,
                 tol=tol_mf, state_err=err_st,
                 ms=median_ms(lambda: DK.agc_fll_rrc(*args1), 20),
                 plain_ms=median_ms(
                     lambda: DK.agc_fll_rrc_plain(*args1), 1, 3),
                 library_ms=None,
                 **k1_work(T, C, len(DK._host_tables()[1])))]

    # K2 on the same stage-1 output (the kernel's), from the carried state
    zero = torch.zeros_like(state.mm_pos)
    st0 = torch.stack([state.mm_pos, state.mm_omega, state.cos_phase,
                       state.cos_freq, state.cos_ph2,
                       state.prev_sym.to(torch.float32), zero, zero])
    args2 = (k1[0], k1[1], st0, n_chunks)
    kw = dict(emit_syms=True, tail_re=state.mm_tail_re.T.contiguous(),
              tail_im=state.mm_tail_im.T.contiguous())
    k2 = MK.mm_costas(*args2, **kw)
    agree = k2_check(k2, args2, kw, n_chunks, what, gate, axis_eps)
    lean = dict(kw, emit_syms=False)
    S = n_chunks * DF.K_SYM
    rows.append(dict(
        name="K2 mm_costas", channels=C, max_abs_err=agree["max_abs_err"],
        channels_identical=agree["channels_identical"],
        first_difference=agree["first_difference"],
        leak_stepped=agree["leak_stepped"], switched=agree["switched"],
        unexplained=agree["unexplained"],
        ms=median_ms(lambda: MK.mm_costas(*args2, **lean), 20),
        plain_ms=median_ms(
            lambda: MK.mm_costas_plain(*args2, **lean), 1, 3),
        full_ms=median_ms(lambda: MK.mm_costas(*args2, **kw), 20),
        full_plain_ms=median_ms(
            lambda: MK.mm_costas_plain(*args2, **kw), 1, 3),
        full_bound_ms=k2_work(T, C, S, emit_syms=True)["bound_ms"],
        library_ms=None,
        **k2_work(T, C, S, emit_syms=False)))
    r1, r2 = rows
    jobs = [(r1, "device_ms", lambda: DK.agc_fll_rrc(*args1)),
            (r2, "device_ms", lambda: MK.mm_costas(*args2, **lean)),
            (r2, "full_device_ms", lambda: MK.mm_costas(*args2, **kw))]
    return rows, jobs


def phase_demod_kernels(dev) -> tuple[list[dict], list]:
    """K1 and K2 against their plain versions on a heterogeneous fleet:
    WARM_BLOCKS blocks (~1.2 s of air: FLL pull-in and timing lock) run
    through the kernel chain, then the next block's inputs go to both
    (demod_rows).  Returns the rows and the profiler jobs."""
    xr, xi = heterogeneous_fleet_iq(WARM_BLOCKS + 1, C_DEMOD, T_DEMOD)
    state = warm_demod(dev, xr, xi, WARM_BLOCKS)
    x_r = torch.from_numpy(xr[WARM_BLOCKS].T.copy()).to(dev)
    x_i = torch.from_numpy(xi[WARM_BLOCKS].T.copy()).to(dev)
    return demod_rows(state, x_r, x_i)


def axis_distance(pairs, valid):
    """Per slot (S, C), the least over the (re, im) pairs of
    min(|re|, |im|) / |z|: how near a sgn() of either component is to
    flipping; inf on slots not valid."""
    ax = torch.stack([torch.minimum(re.abs(), im.abs()) * torch.rsqrt(
        re ** 2 + im ** 2 + 1e-12) for re, im in pairs]).amin(dim=0)
    return torch.where(valid, ax, float("inf"))


def first_switch(bad, ax, gap, G: int) -> dict:
    """For each channel with a bad slot (bad: (S, C)): its first bad slot,
    the least axis distance (axis_distance) of the slots from
    K2_LEAK_LOOKBACK groups of G before it up to it, and the least leak
    gap (|cfreq| from the leak threshold, gap: (groups, C)) of those
    groups."""
    out = {}
    for c in bad.any(dim=0).nonzero()[:, 0].tolist():
        t0 = int(bad[:, c].nonzero()[0, 0])
        g = t0 // G
        lo = max(0, g - K2_LEAK_LOOKBACK)
        out[c] = dict(slot=t0, axis=float(ax[lo * G:t0 + 1, c].min()),
                      leak_gap=float(gap[lo:g + 1, c].min()))
    return out


def k2_plain_traced(args2, kw: dict, n_chunks: int) -> tuple:
    """mm_costas_plain on args2 and kw (emit_syms=True), recording its
    Costas frequency and the symbols of each group: its outputs, each
    slot's axis distance (axis_distance over the symbols and the Costas
    error's inputs), each group's leak gap (|cfreq| from the leak
    threshold, (groups, C)) and the group length G in slots."""
    trace, f0 = [], []
    p2 = MK.mm_costas_plain(*args2, **kw, cfreq_trace=trace, f0_trace=f0)
    pair = n_chunks % 2 == 0
    gap = (torch.stack(trace).abs() - MK._gains(pair)["leak_th"]).abs()
    ax = axis_distance([(p2[0], p2[1]), (torch.cat([a for a, _ in f0]),
                                         torch.cat([b for _, b in f0]))],
                       p2[3].bool())
    return p2, ax, gap, (2 if pair else 1) * DF.K_SYM


def k2_check(k2, args2, kw: dict, n_chunks: int, what: str = "K2",
             gate=check, axis_eps: float | None = None) -> dict:
    """K2's full-form output k2 against mm_costas_plain on the same inputs
    args2 and kw, on their device (the plain run records its Costas
    frequency per group): dibits and valid identical on >= TOL_K2_CHANNELS
    of the channels; the symbols and |sin| dist on the slots both call
    valid within TOL_K2_CLOSE, except on a channel whose plain |cfreq|
    came within K2_LEAK_EPS of the leak threshold in the K2_LEAK_LOOKBACK
    groups before it first differs by more (a leak switch), and there
    within TOL_K2_MAX.

    With axis_eps (marginal SNR), a channel whose plain run has a valid
    symbol within axis_eps of an axis (min(|re|, |im|) / |sym|) in the
    K2_LEAK_LOOKBACK groups before its first difference, or at it, is an
    axis switch: sgn() of the symbol's components decides both its
    quadrant (the dibit) and the Costas error, so a last-bit difference
    there sends the two runs on different trajectories.  Such channels
    are left out of the checks above, and at most K2_AXIS_SHARE of the
    channels may be one.  Returns the readings; gate(cond, what) raises
    on a failed check (check) or records it."""
    p2, ax, gap, G = k2_plain_traced(args2, kw, n_chunks)
    k2 = [t.to(p2[0].device) for t in k2]
    vk, vp = k2[3].bool(), p2[3].bool()
    agree = (vk == vp) & ((k2[2] == p2[2]) | ~vk)
    both = vk & vp
    diff = torch.stack([(k2[i] - p2[i]).abs() for i in (0, 1, 4)])
    diff = torch.where(both[None], diff, 0.0).amax(dim=0)       # (S, C)
    S, C = diff.shape
    switched = {}
    if axis_eps is not None:
        firsts = first_switch(~agree | (diff > TOL_K2_CLOSE), ax, gap, G)
        switched = {c: dict(v, by="leak" if v["leak_gap"] <= K2_LEAK_EPS
                            else "axis") for c, v in firsts.items()
                    if v["axis"] <= axis_eps or v["leak_gap"] <= K2_LEAK_EPS}
        gate(len(switched) <= K2_AXIS_SHARE * C, f"{what}: {len(switched)} "
             f"switched channels, over {K2_AXIS_SHARE} of {C}")
    keep = torch.ones(C, dtype=torch.bool, device=diff.device)
    keep[list(switched)] = False
    same = agree.all(dim=0)
    share = float(same[keep].float().mean())
    # where the differing channels first differ (slot index)
    first = {int(c): int((~agree[:, c]).nonzero()[0, 0])
             for c in (~same).nonzero()[:, 0].tolist()}
    gate(share >= TOL_K2_CHANNELS,
         f"{what} dibits/valid agree on {share:.4f} of channels")
    err_sym = float(diff[:, keep].max())
    gate(err_sym <= TOL_K2_MAX, f"{what} float error {err_sym} > "
         f"{TOL_K2_MAX}")
    stepped = {}
    for c in ((diff.amax(dim=0) > TOL_K2_CLOSE) & keep).nonzero()[
            :, 0].tolist():
        g = int((diff[:, c] > TOL_K2_CLOSE).nonzero()[0, 0]) // G
        near = gap[max(0, g - K2_LEAK_LOOKBACK):g, c]
        stepped[c] = dict(group=g, leak_gap=float(near.min())
                          if len(near) else None)
        gate(len(near) > 0 and float(near.min()) <= K2_LEAK_EPS,
             f"{what} channel {c} differs by > {TOL_K2_CLOSE} from group "
             f"{g} without a leak switch before it: {stepped[c]}")
    return dict(max_abs_err=float(diff.max()), max_abs_err_kept=err_sym,
                channels_identical=float(same.float().mean()),
                channels_identical_kept=share, first_difference=first,
                leak_stepped=stepped, switched=switched,
                unexplained={c: v for c, v in firsts.items()
                             if c not in switched}
                if axis_eps is not None else {})


def k4_rows(x: np.ndarray, n_ch: int, dev) -> list:
    """K4's input rows for a whole wideband capture x, as
    channelizer.channelize builds them: (need, n_ch/2) float32 re, im."""
    hop = n_ch // 2
    n_out = (len(x) - n_ch * CH.TAPS_PER_BRANCH) // hop + 1
    need = n_out + 2 * CH.TAPS_PER_BRANCH - 1
    return [torch.from_numpy(np.ascontiguousarray(
        part, np.float32)[:need * hop].reshape(need, hop)).to(dev)
        for part in (x.real, x.imag)]


def k4_check(zr, zi, n_ch: int, yk) -> tuple[tuple, float, float]:
    """K4's output yk on rows zr/zi against fold_dft_plain on the same rows,
    within TOL_FRONT_REL of the plain output's RMS.  Returns the plain
    output, the largest error and the RMS."""
    yp = CK.fold_dft_plain(zr, zi, n_ch)
    torch.cuda.synchronize()
    rms = float(torch.sqrt((yp[0] ** 2 + yp[1] ** 2).mean()))
    err = max(maxerr(yk[0], yp[0]), maxerr(yk[1], yp[1]))
    check(err <= TOL_FRONT_REL * rms, f"K4 at n_ch={n_ch}, {zr.shape[0]} "
          f"rows: error {err} vs rms {rms}")
    return yp, err, rms


def phase_front_kernels(dev, wide: np.ndarray) -> tuple[list[dict], list]:
    """K4 and K3 against their plain versions over two streamed blocks of
    the synthesized wideband air (front_rows), then K4's and K3's library
    yardsticks and the resample alone (K3's second kernel) on the same
    inputs.  Returns the rows and the profiler jobs (row, key, fn) that
    phase_device_times runs after every timed phase."""
    n = (2 * T50 + 2 * CH.TAPS_PER_BRANCH) * N_CH // 2
    (k3, k4), jobs, io = front_rows(torch.from_numpy(np.ascontiguousarray(
        wide[:n], np.complex64)).to(dev), N_CH)
    z, yk, yp = io["z"], io["yk"], io["yp"]
    hk, t36, a3 = io["history"], io["t36"], io["a3"]
    pad = CH.RS_TAPS_PER_PHASE - 1
    libs = {}
    for label, lib in K4_LIBRARY.items():
        yl = lib(z[0], z[1], N_CH)
        torch.cuda.synchronize()
        err_lib = max(maxerr(yl[0], yp[0]), maxerr(yl[1], yp[1]))
        check(err_lib <= TOL_FRONT_REL * k4["rms"],
              f"K4 yardstick {label}: error {err_lib} vs rms {k4['rms']}")
        t = batch_ms(lambda: lib(z[0], z[1], N_CH), 20, 9)
        libs[label] = dict(ms=float(np.median(t)), min_ms=min(t),
                           max_ms=max(t), max_abs_err=err_lib)
    best = min(libs, key=lambda label: libs[label]["ms"])
    k4.update(host_ms=host_ms(lambda: CK.fold_dft(z[0], z[1], N_CH)),
              library=best, library_ms=libs[best]["ms"], yardsticks=libs)

    # the resample alone (K3's second kernel) on K4's output
    a_rs = (yk[0], yk[1], hk[0], hk[1], t36)
    rs = CK.resample(*a_rs)
    rs_p = CH._resample_stream_block_fm(*a_rs)
    torch.cuda.synchronize()
    rms_rs = float(torch.sqrt((rs_p[0] ** 2 + rs_p[1] ** 2).mean()))
    err_rs = max(maxerr(rs[0], rs_p[0]), maxerr(rs[1], rs_p[1]))
    check(err_rs <= TOL_FRONT_REL * rms_rs,
          f"resample error {err_rs} vs rms {rms_rs}")
    for tails in (rs[2:], hk):          # the resample's, K3's
        check(torch.equal(tails[0], yk[0][-pad:])
              and torch.equal(tails[1], yk[1][-pad:]),
              "next block's history differs from K4's last rows")
    t_rs = batch_ms(lambda: CK.resample(*a_rs), 20, 9)
    w_rs = resample_work(T50, N_CH, t36)

    r3 = CK.fold_dft_resample_plain(*a3)
    l3 = k3_library(best, *a3)
    torch.cuda.synchronize()
    err_l3 = max(maxerr(l3[0], r3[0]), maxerr(l3[1], r3[1]))
    check(err_l3 <= TOL_FRONT_REL * k3["rms"],
          f"K3 yardstick {best} + resample: error {err_l3} vs rms "
          f"{k3['rms']}")
    tl3 = batch_ms(lambda: k3_library(best, *a3), 20, 9)
    k3.update(
        host_ms=host_ms(lambda: CK.fold_dft_resample(*a3)),
        resample_ms=float(np.median(t_rs)), resample_min_ms=min(t_rs),
        resample_max_ms=max(t_rs),
        resample_host_ms=host_ms(lambda: CK.resample(*a_rs)),
        resample_bound_ms=w_rs["bound_ms"],
        resample_bound_by=w_rs["bound_by"], resample_bytes=w_rs["bytes"],
        resample_max_abs_err=err_rs, resample_rms=rms_rs,
        resample_plain_ms=median_ms(
            lambda: CH._resample_stream_block_fm(*a_rs), 1, 3),
        library=best + ", then the resample einsum",
        library_ms=float(np.median(tl3)), library_min_ms=min(tl3),
        library_max_ms=max(tl3), library_max_abs_err=err_l3)
    jobs.insert(1, (k3, "resample_device_ms", lambda: CK.resample(*a_rs)))
    return [k3, k4], jobs


def phase_device_times(jobs: list) -> None:
    """Each job's device_ms (and its kernels' rows) into its row.  Runs
    last: launches right after a torch.profiler session take longer on
    the host, which would show in the event times and the slice."""
    for row, key, fn in jobs:
        row[key], per = device_ms(fn)
        row[key.replace("device_ms", "device_kernels_ms")] = per


def phase_slice(dev, staged: list) -> tuple[dict, dict]:
    """The wideband fleet receiver over the staged air, timed after a
    1.5 s warm-up (FLL pull-in + scrambling acquisition).  Returns the
    phase's line and the typed FEC's last trellis input of each length
    over the timed superblocks ({steps: soft})."""
    rx = TetraReceiver(wideband=N_CH, t50=T50, fleet=True, wb_k=WB_K,
                       device=dev)
    sb_adv = WB_K * rx._wb["advance"]
    n_super = len(staged)
    torch.cuda.synchronize()
    fs = N_CH * 25_000
    warm = int(1.5 * fs / sb_adv) + 1
    check(n_super - warm >= 2, f"{n_super} superblocks, {warm} warm-up")
    wrappers = zero_launches()
    for s in range(warm):
        rx.process_wideband_staged(*staged[s])
    ok0 = sum(rx.crc_counts(c)[0] for c in range(N_CH))
    fail0 = sum(rx.crc_counts(c)[1] for c in range(N_CH))
    torch.cuda.synchronize()
    # the typed FEC reaches the trellis through its module's viterbi_decode
    decode, soft_in = FEC.viterbi_decode, {}

    def spy(soft, code="cch", term="zero"):
        soft_in[soft.shape[1]] = soft
        return decode(soft, code, term)

    FEC.viterbi_decode = spy
    trellis0, n_rec0 = FT.trellis.launches, len(SPANS.records())
    t0 = time.perf_counter()
    walls = []
    try:
        for s in range(warm, n_super):
            ts = time.perf_counter()
            rx.process_wideband_staged(*staged[s])
            walls.append(time.perf_counter() - ts)
    finally:
        FEC.viterbi_decode = decode
    dt = time.perf_counter() - t0
    trellis_launches = FT.trellis.launches - trellis0
    rec = SPANS.records()[n_rec0:]
    launches = read_launches(wrappers)
    gates = fleet_gates(rx, ok0, fail0, "slice")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    check(len(rec) == len(walls) and 0 < trellis_launches
          <= 2 * len(walls), f"the FEC trellis launched {trellis_launches} "
          f"times in {len(walls)} superblocks ({len(rec)} records)")
    sb_air = sb_adv / fs
    return dict(channels=N_CH, t50=T50, wb_k=WB_K, superblocks=len(walls),
                superblocks_driven=n_super,
                wideband_msps=(n_super - warm) * sb_adv / dt / 1e6,
                rt_margin=sb_air / float(np.mean(walls)),
                sb_air_ms=sb_air * 1e3,
                sb_wall_ms=float(np.mean(walls)) * 1e3,
                fleet_threads=rx.fleet.threads, **gates, launches=launches,
                trellis_launches=trellis_launches,
                fec_rows=int(rec["fec.rows"].sum()),
                fec_trellis_rows=int(rec["fec.trellis_rows"].sum())), soft_in


def fleet_gates(rx, ok0: int, fail0: int, what: str,
                quality: bool = False) -> dict:
    """The fleet slice's three decode gates on rx's counts since
    (ok0, fail0), over its channels; with quality, a fourth: > 90% of
    them passing quality_ok."""
    n_ch = rx.channels
    n_locked = sum(rx.locked(c) for c in range(n_ch))
    oks = sum(rx.crc_counts(c)[0] for c in range(n_ch)) - ok0
    fails = sum(rx.crc_counts(c)[1] for c in range(n_ch)) - fail0
    right_cell = sum(rx.display(c).mcc == 262
                     and rx.display(c).mnc == 100 + c % N_CELLS
                     for c in range(n_ch))
    check(n_locked > 0.9 * n_ch, f"{what}: only {n_locked}/{n_ch} locked")
    check(oks > 3 * fails and oks > 0, f"{what}: crc ok {oks} vs fail "
          f"{fails}")
    check(right_cell > 0.9 * n_ch, f"{what}: only {right_cell} channels "
          f"show their cell's MCC/MNC")
    out = dict(locked=n_locked, crc_ok=oks, crc_fail=fails,
               right_cell=right_cell)
    if quality:
        out["quality_ok"] = sum(rx.quality_ok(c) for c in range(n_ch))
        check(out["quality_ok"] > 0.9 * n_ch, f"{what}: only "
              f"{out['quality_ok']}/{n_ch} pass quality_ok")
    return out


# slice_pipeline's receivers: (link_profile, fleet threads); None = the
# profile's default.  "pcie" and "tunnel" are the contract's pair;
# "tunnel_all_cores" takes the pcie profile's thread count without its
# pipeline
PIPE_CONFIGS = {"pcie": ("pcie", None),
                "tunnel": ("tunnel", None),
                "tunnel_all_cores": ("tunnel", os.cpu_count() or 2)}
PIPE_STAGES = [(R, "_wideband_step_scan", "step enqueue"),
               (R.FleetEngine, "process_packed2", "fleet engine call"),
               (FEC, "decode_rows_typed_packed", "of which typed FEC")]


def pipeline_receiver(dev, profile: str, threads):
    env = os.environ.get("TETRA_FLEET_THREADS")
    if threads is not None:
        os.environ["TETRA_FLEET_THREADS"] = str(threads)
    try:
        return TetraReceiver(wideband=N_CH, t50=T50, fleet=True, wb_k=WB_K,
                             link_profile=profile, device=dev)
    finally:
        if env is None:
            os.environ.pop("TETRA_FLEET_THREADS", None)
        else:
            os.environ["TETRA_FLEET_THREADS"] = env


def phase_slice_pipeline(dev, staged: list) -> tuple[dict, object]:
    """The fleet slice's air through TetraReceiver(..., link_profile=
    "pcie") (superblocks double-buffered: the step on the receiver's side
    stream, the output fetched into pinned buffers; fleet workers on every
    core), its tunnel-profile twin and the other PIPE_CONFIGS, taking
    turns superblock by superblock (the order rotates each superblock).
    Each timed call of a pipelined receiver enqueues one superblock and
    decodes the one before, so its CRC tallies since the warm-up count one
    superblock more than a synchronous receiver's until the flush.
    Host-clock stage times per receiver (PIPE_STAGES; "rest" = wall -
    step - fleet call: the fetch or the wait for the pinned copy, and the
    quality rows).  Gates after flush_wideband(): locks, CRC tallies,
    display, lock losses and the engine's state blob equal on every
    channel for every receiver; the slice's decode gates; K1-K4 launched
    WB_K times a superblock by each, the pcie receiver's, and its
    pack_cycle_tc's torch ops, on its side stream only, its FEC's trellis
    kernels on the caller's stream.  Returns the phase's results and a job
    that profiles the pcie and tunnel receivers over the last
    PIPE_PROFILED superblocks fed again (run last; the air jumps back, the
    device work is the same)."""
    rxs = {k: pipeline_receiver(dev, *cfg) for k, cfg in PIPE_CONFIGS.items()}
    pcie, tun = rxs["pcie"], rxs["tunnel"]
    cores = os.cpu_count() or 2
    check(pcie.wb_pipeline and not tun.wb_pipeline
          and not rxs["tunnel_all_cores"].wb_pipeline
          and pcie.fleet.threads == rxs["tunnel_all_cores"].fleet.threads
          == cores and tun.fleet.threads == max(1, cores - 1),
          "the pcie profile did not switch its mechanisms on")
    sb_adv = WB_K * pcie._wb["advance"]
    fs = N_CH * 25_000
    warm = int(WARM_SECONDS * fs / sb_adv) + 1
    check(len(staged) - warm >= 2, f"{len(staged)} superblocks, {warm} "
          f"warm-up")

    # host clock of each receiver's stages, and the streams its kernel
    # wrappers launch on
    cur = [None]
    acc = {k: dict.fromkeys((st for _, _, st in PIPE_STAGES), 0.0)
           for k in rxs}
    # kernel streams outside and inside the typed FEC (its trellis kernel
    # runs on the caller's stream, after the fetch)
    streams, fec_streams, in_fec = [], [], [False]
    saved = [(o, n, getattr(o, n)) for o, n, _ in PIPE_STAGES]
    decode, stream_of = FEC.decode_rows_typed_packed, _build.stream_of

    def timed(fn, stage):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            in_fec[0] = fn is decode
            try:
                return fn(*args, **kw)
            finally:
                in_fec[0] = False
                if cur[0] is not None:
                    acc[cur[0]][stage] += time.perf_counter() - t0
        return wrapper

    def spy_stream(t):
        seen = fec_streams if in_fec[0] else streams
        seen.append(stream_of(t))
        return seen[-1]

    pack = R.pack_cycle_tc

    def spy_pack(*args):
        # pack_cycle_tc's torch ops go to the stream current at its call
        streams.append(torch.cuda.current_stream(dev).cuda_stream)
        return pack(*args)

    for (owner, name, fn), (_, _, stage) in zip(saved, PIPE_STAGES):
        setattr(owner, name, timed(fn, stage))
    _build.stream_of, R.pack_cycle_tc = spy_stream, spy_pack
    launches = {k: dict.fromkeys(kernel_wrappers(), 0) for k in rxs}
    walls = {k: [] for k in rxs}
    pcie_streams, pcie_fec_streams = set(), set()
    keys = list(rxs)
    try:
        for s, sb in enumerate(staged):
            if s == warm:
                base = {k: (sum(rx.crc_counts(c)[0] for c in range(N_CH)),
                            sum(rx.crc_counts(c)[1] for c in range(N_CH)))
                        for k, rx in rxs.items()}
                acc = {k: dict.fromkeys(v, 0.0) for k, v in acc.items()}
            for k in keys[s % len(keys):] + keys[:s % len(keys)]:
                cur[0] = k
                wrappers = zero_launches()
                streams.clear()
                fec_streams.clear()
                ts = time.perf_counter()
                rxs[k].process_wideband_staged(*sb)
                dt = time.perf_counter() - ts
                for name, n in read_launches(wrappers).items():
                    launches[k][name] += n
                if k == "pcie":
                    pcie_streams.update(streams)
                    pcie_fec_streams.update(fec_streams)
                if s >= warm:
                    walls[k].append(dt)
        cur[0] = None                   # the flushes are not timed
        for rx in rxs.values():
            rx.flush_wideband()
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
        _build.stream_of, R.pack_cycle_tc = stream_of, pack
    torch.cuda.synchronize()

    same = {}
    for k, rx in rxs.items():
        if k == "tunnel":
            continue
        n_same = dict(locked=0, crc_counts=0, display=0, lock_losses=0)
        for c in range(N_CH):
            n_same["locked"] += rx.locked(c) == tun.locked(c)
            n_same["crc_counts"] += rx.crc_counts(c) == tun.crc_counts(c)
            n_same["display"] += (rx.display(c).as_dict()
                                  == tun.display(c).as_dict())
            n_same["lock_losses"] += (rx.fleet.lock_losses(c)
                                      == tun.fleet.lock_losses(c))
        n_same["state_bytes"] = (rx.fleet.state_bytes()
                                 == tun.fleet.state_bytes())
        same[k] = n_same
        check(all(v == N_CH for v in list(n_same.values())[:4])
              and n_same["state_bytes"], f"{k} vs tunnel after flush: "
              f"{n_same}")
    gates = {k: fleet_gates(rx, *base[k], f"slice_pipeline {k}")
             for k, rx in rxs.items()}
    for k in rxs:
        for name, n in launches[k].items():
            check(n == WB_K * len(staged), f"{k}: {name} launched {n} "
                  f"times in {len(staged)} superblocks")
    side = pcie._side.cuda_stream
    caller = torch.cuda.default_stream(dev).cuda_stream
    check(pcie_streams == {side} and side != caller,
          f"pcie kernels and packing ran on streams {pcie_streams}, side "
          f"{side}")
    check(pcie_fec_streams == {caller}, f"pcie FEC trellis kernels ran on "
          f"streams {pcie_fec_streams}, the caller's {caller}")

    sb_air = sb_adv / fs
    res = dict(superblocks=len(staged), warm=warm, sb_air_ms=sb_air * 1e3,
               configs=PIPE_CONFIGS, same_as_tunnel=same)
    for k, rx in rxs.items():
        ms = np.asarray(walls[k]) * 1e3
        w = dict(mean=float(ms.mean()), min=float(ms.min()),
                 max=float(ms.max()))
        stage_ms = {st: sec * 1e3 / len(walls[k])
                    for st, sec in acc[k].items()}
        stage_ms["rest"] = (w["mean"] - stage_ms["step enqueue"]
                            - stage_ms["fleet engine call"])
        res[k] = dict(gates[k], wb_pipeline=rx.wb_pipeline,
                      threads=rx.fleet.threads,
                      launches=launches[k], sb_wall_ms=w,
                      stage_ms_per_sb=stage_ms,
                      rt_margin=sb_air / (w["mean"] / 1e3),
                      latency_ms=(sb_air * (1 + rx.wb_pipeline)
                                  + w["mean"] / 1e3) * 1e3)

    def profile_job():
        """Busy share (device kernel time over wall) of the pcie and
        tunnel receivers over PIPE_PROFILED superblocks, in one
        torch.profiler window each."""
        for k in ("pcie", "tunnel"):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for sb in staged[-PIPE_PROFILED:]:
                    rxs[k].process_wideband_staged(*sb)
                rxs[k].flush_wideband()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy = sum(_device_ms(e) for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
            res[k]["profile"] = dict(superblocks=PIPE_PROFILED,
                                     wall_ms=wall, device_ms=busy,
                                     busy_share=busy / wall)

    return res, profile_job


class StageClock:
    """Host-clock time of named stages: wraps owner.name so each call adds
    its time to its stage, and puts every original back on close.  No
    synchronize is added: a stage that ends in a device fetch includes the
    device work it waits for."""

    def __init__(self):
        self.sec = {}
        self.calls = {}
        self._saved = []

    def wrap(self, owner, name: str, stage: str) -> None:
        fn = getattr(owner, name)
        self._saved.append((owner, name, fn))
        self.sec.setdefault(stage, 0.0)
        self.calls.setdefault(stage, 0)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.sec[stage] += time.perf_counter() - t0
                self.calls[stage] += 1

        setattr(owner, name, timed)

    def close(self) -> None:
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved = []


# host-clock stages of the receiver's decode, after its demod
DECODE_STAGES = [
    (TetraReceiver, "_sync_bursts", "burst sync + device acquire"),
    (LM, "decode_bursts_multi", "FEC"),
    (LM.LowerMac, "_dispatch_decoded", "MAC dispatch")]


def drive_receiver(rx, feed, blocks: list, n_warm: int, n_ch: int,
                   what: str, unit: str, stages: list, rest: str,
                   inner=(), at_warm=None) -> dict:
    """Drive a per-channel receiver: feed(block) over blocks[:n_warm]
    untimed, at_warm(), then each later block timed, with the host-clock
    time per block of stages (owner, name, stage; what they leave of the
    wall under `rest`) and of inner stages nested inside them.  Counts the
    kernels' launches from the first block on, and checks the decode gates
    after warm-up: > 90% of channels locked, > 90% showing their own cell's
    MCC/MNC with all N_CELLS cells shown, crc_ok > 3 x crc_fail, > 90%
    passing quality_ok."""
    wrappers = zero_launches()
    for block in blocks[:n_warm]:
        feed(block)
    ok0 = sum(rx.crc_counts(c)[0] for c in range(n_ch))
    fail0 = sum(rx.crc_counts(c)[1] for c in range(n_ch))
    if at_warm is not None:
        at_warm()
    clock, inner_clock = StageClock(), StageClock()
    for owner, name, stage in stages:
        clock.wrap(owner, name, stage)
    for owner, name, stage in inner:
        inner_clock.wrap(owner, name, stage)
    walls = []
    try:
        for block in blocks[n_warm:]:
            ts = time.perf_counter()
            feed(block)
            walls.append(time.perf_counter() - ts)
    finally:
        inner_clock.close()
        clock.close()
    launches = read_launches(wrappers)
    n_locked = sum(rx.locked(c) for c in range(n_ch))
    oks = sum(rx.crc_counts(c)[0] for c in range(n_ch)) - ok0
    fails = sum(rx.crc_counts(c)[1] for c in range(n_ch)) - fail0
    shown = [(rx.display(c).mcc, rx.display(c).mnc) for c in range(n_ch)]
    right_cell = sum(s == (262, 100 + c % N_CELLS)
                     for c, s in enumerate(shown))
    cells = {s for s in shown if s[0] == 262}
    quality = sum(rx.quality_ok(c) for c in range(n_ch))
    check(n_locked > 0.9 * n_ch, f"{what}: only {n_locked}/{n_ch} locked")
    check(oks > 3 * fails and oks > 0, f"{what}: crc ok {oks} vs fail "
          f"{fails}")
    check(right_cell > 0.9 * n_ch and len(cells) == N_CELLS,
          f"{what}: {right_cell} channels show their cell, cells {cells}")
    check(quality > 0.9 * n_ch, f"{what}: only {quality}/{n_ch} pass "
          f"quality_ok")
    n_t = len(walls)
    mean_ms = float(np.mean(walls)) * 1e3
    stage_ms = {k: v * 1e3 / n_t for k, v in clock.sec.items()}
    stage_ms[rest] = mean_ms - sum(stage_ms.values())
    return {f"{unit}s_timed": n_t, f"{unit}_wall_ms": mean_ms,
            f"{unit}_wall_min_ms": min(walls) * 1e3,
            f"{unit}_wall_max_ms": max(walls) * 1e3,
            f"stage_ms_per_{unit}": stage_ms,
            "inner": {stage: {f"ms_per_{unit}": sec * 1e3 / n_t,
                              "calls": inner_clock.calls[stage],
                              "ms_per_call": sec * 1e3
                              / max(1, inner_clock.calls[stage])}
                      for stage, sec in inner_clock.sec.items()},
            "locked": n_locked, "crc_ok": oks, "crc_fail": fails,
            "right_cell": right_cell, "cells": len(cells),
            "quality_ok": quality, "launches": launches}


def cycle_chunks(rx, wide: np.ndarray, seconds: float) -> tuple[list, int]:
    """A per-channel wideband receiver's host cf32 feed of the first
    `seconds` of wide: the first window's head, then one cycle's advance a
    chunk; and the cycles of WARM_SECONDS (+ 1)."""
    adv, wl = rx._wb["advance"], rx._wb["wide_len"]
    fs = rx.channels * 25_000
    n_cyc = int((seconds * fs - (wl - adv)) // adv)
    return ([wide[:wl - adv]] + [wide[wl - adv + k * adv:wl + k * adv]
                                 for k in range(n_cyc)],
            int(WARM_SECONDS * fs / adv) + 1)


def phase_slice_nonfleet(dev, wide: np.ndarray, n_ch: int = N_CH,
                         attach=None, stages=(), at_warm=None) -> dict:
    """The per-channel receiver as the CLI builds it, fed host cf32 chunks
    of one cycle's advance (the first window primed), timed per cycle after
    WARM_SECONDS of warm-up.  attach(rx) runs once the receiver is built,
    at_warm() at the end of the warm-up; stages are more (owner, name,
    stage) to time over the timed cycles, returned under "stages" with
    their ms per cycle, calls and ms per call."""
    rx = TetraReceiver(wideband=n_ch, t50=T50, events=False, device=dev)
    if attach is not None:
        attach(rx)
    check(rx.fleet is None and rx.device_acquire,
          "the CLI's receiver is per-channel with device acquisition")
    adv, fs = rx._wb["advance"], n_ch * 25_000
    chunks, warm = cycle_chunks(rx, wide, NONFLEET_SECONDS)
    n_cyc = len(chunks) - 1
    check(n_cyc - warm >= math.ceil(2.0 * fs / adv),
          f"{n_cyc} cycles, {warm} warm-up: under 2 s timed")
    # the inner stages: inside the FEC stage, the fused decode call (its
    # rows built, moved to the card, decoded and fetched) and, inside
    # that, the decode's torch ops as the host issues them
    fec = ("decode_blocks_mixed", "decode ops issued")
    res = drive_receiver(
        rx, rx.process_wideband, chunks, warm + 1, n_ch, "per-channel",
        "cycle", [(R, "_wideband_step", "device step + fetch"),
                  (TetraReceiver, "_fetch", "device step + fetch"),
                  *DECODE_STAGES],
        "rest (framing, upload, demod host work)",
        inner=[(FEC, "decode_blocks_mixed", fec[0]),
               (FEC, "_decode_mixed_core", fec[1]), *stages],
        at_warm=at_warm)
    inner = res.pop("inner")
    const = [len(rx.constellation(c)[0]) for c in range(n_ch)
             if rx.locked(c)]
    check(all(n > 0 for n in const),
          f"{sum(n == 0 for n in const)} locked channels show no "
          f"constellation (K2's full form)")
    for name, n in res["launches"].items():
        check(n > 0, f"{name} was not launched on the per-channel path")
    check(rx.acquire_scans > 0, "device_acquire_scan never ran")
    air_ms = adv / fs * 1e3
    return dict(res, channels=n_ch, t50=T50, cycles_driven=n_cyc,
                cycle_air_ms=air_ms,
                wideband_msps=adv / res["cycle_wall_ms"] / 1e3,
                rt_margin=air_ms / res["cycle_wall_ms"],
                fec_ms_per_cycle={k: inner[k]["ms_per_cycle"] for k in fec},
                constellation_channels=len(const),
                acquire_scans=rx.acquire_scans,
                launches_per_cycle={k: v / n_cyc
                                    for k, v in res["launches"].items()},
                warm_cycles=warm, advance=adv, fs=fs,
                stages={stage: inner[stage] for _, _, stage in stages})


class SpyDecoder:
    """An AcelpDecoder that records every call: the TDMA time its pipeline
    is decoding (set by RecordingPipeline), the kind ("slot" or the stolen
    slot's "frame"), the codec bits and the bad-frame flag."""

    def __init__(self):
        self.inner = AcelpDecoder()
        self.calls = []
        self.key = None

    def decode_slot(self, frames, bfi=False):
        self.calls.append((self.key, "slot",
                           np.array(frames, np.uint8).reshape(2, 137),
                           bool(bfi)))
        return self.inner.decode_slot(frames, bfi)

    def decode_frame(self, bits, bfi=False):
        self.calls.append((self.key, "frame", np.array(bits, np.uint8),
                           bool(bfi)))
        return self.inner.decode_frame(bits, bfi)


class RecordingPipeline(VoicePipeline):
    """A VoicePipeline whose spy decoder learns the TDMA time of each
    call."""

    def _gate(self, time):
        self.decoder.key = (time.mn, time.fn, time.tn)
        return super()._gate(time)


def replay_audio(calls) -> np.ndarray:
    """What a fresh AcelpDecoder makes of the recorded calls, in order
    (a stolen slot's lost frame is 240 samples of silence)."""
    dec = AcelpDecoder()
    out = [dec.decode_slot(f, b) if kind == "slot"
           else np.concatenate([np.zeros(240, np.int16),
                                dec.decode_frame(f, b)])
           for _, kind, f, b in calls]
    return np.concatenate(out) if out else np.zeros(0, np.int16)


def voice_truth(records, lo: int, hi: int) -> dict:
    """{(mn, fn, tn): ("slot", (2, 137) frames) or ("frame", frame 2)} of
    the voice-bearing slots records[lo:hi] (first-half steals keep their
    second frame; both-halves steals carry no voice)."""
    out = {}
    for r in records[lo:hi]:
        key = (r.time.mn, r.time.fn, r.time.tn)
        if r.kind == "voice":
            out[key] = ("slot", np.asarray(r.type1["frames"]).reshape(2, 137))
        elif r.kind == "stch" and "frames" in r.type1:
            out[key] = ("frame", np.asarray(r.type1["frames"])[1])
    return out


def phase_slice_voice(dev, nf: dict, n_ch: int = N_CH,
                      seconds: float = NONFLEET_SECONDS,
                      n_cells: int = N_CELLS) -> dict:
    """The per-channel receiver of slice_nonfleet on air with traffic: one
    VoicePipeline on carrier c < n_cells (one per cell), the TEA1 cells'
    channels with one CryptoState from a keystore file on the upper MAC
    and the pipeline, and the event log on for them (the CLI's -v)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        keys = os.path.join(tmp, "keys.txt")
        with open(keys, "w") as f:
            f.write(cell_keystore(ENCRYPTED))
        wide, records = voice_cell_air(n_ch, seconds, n_cells, keystore=keys,
                                       encrypted=ENCRYPTED)
        stores = {c: KeyStore.load(keys) for c in ENCRYPTED}
    fixture_s = time.perf_counter() - t0
    pipes, cipher, half_ks, events0, devices, rxs = {}, {}, {}, {}, set(), []

    def spy_crypto(cs, log, ks_log):
        """Record the frames each voice decryption starts from, and whether
        the cipher context was whole by then: the SYSINFO PDUs of both arms
        (the CCK id and the hyperframe number) received; and each slot's
        keystream as the cipher state made it."""
        arms = set()
        decrypt, update = cs.decrypt_voice_bits, cs.update_from_sysinfo
        keystream = cs.keystream_bits

        def spy_keystream(key, t, num_bits, direction=0):
            out = keystream(key, t, num_bits, direction)
            ks_log[(t.mn, t.fn, t.tn)] = out
            return out

        def spy_update(sid):
            arms.add(bool(sid.cck_valid_no_hf))
            return update(sid)

        def spy_decrypt(t, frames):
            log[(t.mn, t.fn, t.tn)] = (frames.copy(), len(arms) == 2)
            return decrypt(t, frames)
        cs.update_from_sysinfo = spy_update
        cs.decrypt_voice_bits = spy_decrypt
        cs.keystream_bits = spy_keystream

    def attach(rx):
        rxs.append(rx)
        for c in range(n_cells):
            cs = None
            if c in ENCRYPTED:
                cs = CryptoState(store=stores[c])
                spy_crypto(cs, cipher.setdefault(c, {}),
                           half_ks.setdefault(c, {}))
                rx.mac[c].upper.crypto_state = cs
                rx.mac[c].upper.events_enabled = True
            pipes[c] = RecordingPipeline(decoder=SpyDecoder(),
                                         crypto_state=cs, device=dev)
            rx.mac[c].voice_cb = pipes[c]

    def at_warm():
        for c, vp in pipes.items():
            events0[c] = len(rxs[0].mac[c].upper.events)
            vp.warm_calls = len(vp.decoder.calls)

    def on_device(fn):
        """Note the devices of the decode's inputs and outputs."""
        def run(type4, perm):
            out = fn(type4, perm)
            devices.update({type4.device.type, perm.device.type,
                            out[0].device.type})
            return out
        return run

    saved = VCH._decode_slot_device, VCH._decode_half_device
    VCH._decode_slot_device, VCH._decode_half_device = map(on_device, saved)
    try:
        res = phase_slice_nonfleet(
            dev, wide, n_ch, attach=attach, at_warm=at_warm,
            stages=[(VoicePipeline, "__call__", "voice"),
                    (VoicePipeline, "half", "voice (half)"),
                    (VCH, "decode_slot", "channel decode"),
                    (VCH, "decode_half_slot", "channel decode (half)"),
                    (SpyDecoder, "decode_slot", "ACELP"),
                    (SpyDecoder, "decode_frame", "ACELP (half)")])
    finally:
        VCH._decode_slot_device, VCH._decode_half_device = saved
    rx = rxs[0]
    check(devices == {dev.type}, f"speech decode tensors on {devices}")
    check(all(vp.device == dev for vp in pipes.values()),
          "a pipeline decodes off the receiver's device")
    # slot j of a carrier starts at 36 kHz sample 510 j: the slots whose
    # air the timed cycles carried, less a margin at each end
    slot_of = lambda wide_samples: wide_samples / res["fs"] * 36_000 / 510
    lo = int(slot_of(res["warm_cycles"] * res["advance"])) + 2
    hi = int(slot_of(res["cycles_driven"] * res["advance"])) - 4
    per, n_half_ok, n_dec, n_bad, n_dark, n_clear = {}, 0, 0, 0, 0, {}
    for c, vp in pipes.items():
        truth = voice_truth(records[c], lo, hi)
        calls = vp.decoder.calls
        timed = [x for x in calls[vp.warm_calls:] if x[0] in truth]
        decoded = {x[0] for x in timed}
        check(len(decoded) >= MIN_VOICE_SHARE * len(truth) and truth,
              f"carrier {c}: decoded {len(decoded)} of {len(truth)} voice "
              f"slots after warm-up")
        bad = sum(b for _, _, _, b in timed)
        n_dec += len(timed)
        n_bad += bad
        for key, kind, frames, b in timed:
            want_kind, want = truth[key]
            check(kind == want_kind, f"carrier {c} {key}: {kind} decode of "
                  f"a {want_kind} slot")
            if b:
                continue
            if kind == "frame" and c in ENCRYPTED:
                # the fixture sends a first-half steal's surviving frame in
                # the clear; the pipeline, once it holds the key, XORs the
                # slot's keystream bits 137-273 off it (as the benchmark's
                # air enciphers it), so the frame XORed with them again is
                # the sent one
                ks = half_ks[c].get(key)
                if ks is not None:
                    frames = frames ^ ks[137:]
            if kind == "slot" and c in ENCRYPTED:
                on_air, context = cipher[c][key]
                check(not np.array_equal(on_air, want),
                      f"carrier {c} {key}: frames not encrypted on air")
                if not context:
                    # the keystream needs both SYSINFO arms; until the
                    # receiver has seen them its plaintext is wrong
                    n_dark += 1
                    continue
                n_clear[c] = n_clear.get(c, 0) + 1
            check(np.array_equal(frames, want),
                  f"carrier {c} {key}: codec frames differ from the sent")
            if kind == "frame":
                n_half_ok += 1
        audio = vp.take_audio()
        check(len(audio) == 480 * vp.slots_decoded == 480 * len(calls),
              f"carrier {c}: {len(audio)} samples for {vp.slots_decoded} "
              f"slots")
        check(np.array_equal(audio, replay_audio(calls)),
              f"carrier {c}: audio differs from a fresh decoder's")
        sdus = 0
        if c in ENCRYPTED:
            sdus = decrypted_sdus(rx.mac[c].upper.events[events0[c]:])
            check(sdus > 0, f"carrier {c}: no decrypted SDU after warm-up")
            check(n_clear.get(c, 0) > 0,
                  f"carrier {c}: no voice slot decrypted after warm-up")
        per[c] = dict(voice_slots=len(truth), decoded=len(decoded),
                      calls=len(calls), bad=bad, decrypted_sdus=sdus,
                      decrypted_slots=n_clear.get(c, 0))
    check(n_bad <= MAX_BAD_SHARE * n_dec,
          f"{n_bad} bad frames in {n_dec} decoded slots")
    check(n_half_ok > 0, "no stolen-half decode ran and matched")
    out = {k: v for k, v in res.items() if k != "stages"}
    out.update(fixture_s=fixture_s, carriers=per, slots_decoded=n_dec,
               bad_frames=n_bad, half_decodes_matched=n_half_ok,
               encrypted_slots_before_context=n_dark,
               decrypted_sdus=sum(v["decrypted_sdus"] for v in per.values()),
               voice_stages=res["stages"],
               slice_nonfleet={k: nf.get(k) for k in (
                   "wideband_msps", "rt_margin", "cycle_wall_ms")})
    return out


def trellis_work(rows: int, steps: int, nb: int, flag_bytes: int) -> dict:
    """A 16-state trellis kernel's bound: its soft symbols (nb float32 a
    step) and flag_bytes of per-row flags read once, its bits written
    once; per row and step 2**nb branch metrics (nb - 1 additions each),
    16 add-compare-selects (3 operations each) and a traceback step (1)."""
    return bound(rows * steps * (nb * 4 + 1) + flag_bytes,
                 rows * steps * (2 ** nb * (nb - 1) + 16 * 3 + 1))


def fec_trellis_rows(soft_in: dict) -> list[dict]:
    """The FEC trellis kernel at the fleet's shapes, from the fleet slice's
    timed superblocks: the last SB1/NDB pass (144 steps), that pass 4
    times over (band1024's rows), and an SCH-F pass (288 steps; the
    slice's air sends no SCH-F, so SCHF_TRELLIS_ROWS rows of two SB1/NDB
    rows end to end, unless the air sent one), each bit for bit against
    the plain twin _viterbi on the card and timed beside it."""
    short = soft_in[FEC._SHORT_T2]
    schf = soft_in.get(FEC._MIX_T2)
    if schf is None:
        n = SCHF_TRELLIS_ROWS
        pick = torch.arange(2 * n, device=short.device) % short.shape[0]
        schf = torch.cat([short[pick[:n]], short[pick[n:]]], dim=1)
    rows = []
    for x in (short, torch.cat([short] * 4), schf):
        x = x.contiguous()
        R_, T_ = x.shape[0], x.shape[1]
        got = FT.trellis(x, False)
        check(torch.equal(got, V._viterbi(x, False, False)),
              f"FEC trellis differs from _viterbi at {R_} x {T_}")
        rows.append(dict(
            name="fec_trellis", rows=R_, steps=T_, max_abs_err=0.0,
            ms=median_ms(lambda: FT.trellis(x, False), 20),
            plain_ms=median_ms(lambda: V._viterbi(x, False, False), 1, 3),
            **trellis_work(R_, T_, 4, 0)))
    return rows


def replay_calls(blocks: list, carriers) -> int:
    """Check the PCM of every call on `carriers` over `blocks` (all of the
    receiver's voice blocks, oldest first) against a fresh AcelpDecoder a
    call, made on its first synthesised row and fed its frames in order
    (a half: 240 samples of silence, then its frame; a withheld row: 480
    samples of silence, the decoder untouched).  Returns the rows
    checked."""
    decs, n = {}, 0
    for b in blocks:
        for i in np.nonzero(np.isin(b.carrier, carriers))[0]:
            call = (int(b.carrier[i]), int(b.timeslot[i]))
            if b.crypt[i] == VM.WITHHELD:
                want = np.zeros(480, np.int16)
            else:
                dec = decs.setdefault(call, AcelpDecoder())
                f, bfi = b.frames[i], b.bfi[i]
                first = (np.zeros(240, np.int16) if b.kind[i] == VM.HALF
                         else dec.decode_frame(f[0], bool(bfi[0])))
                want = np.concatenate([first,
                                       dec.decode_frame(f[1], bool(bfi[1]))])
            check(np.array_equal(b.pcm[i], want),
                  f"call {call} at {tuple(b.time[i])}: PCM differs from a "
                  f"fresh decoder's")
            n += 1
    return n


def phase_slice_voice_fleet(dev) -> tuple[dict, dict]:
    """The fleet receiver with its voice monitor, TetraReceiver(wideband=
    256, t50=6400, fleet=True, wb_k=8, voice=True, keystore=...), on
    FLEET_VOICE_SECONDS of voice_cell_air's air at 256 carriers (voice on
    timeslot 2, steals of both kinds, cells 4-7 TEA1 with the keys held):
    staged superblocks after a 1.5 s warm-up, take_voice() after each.
    Returns the phase's line and the speech trellis kernel's row."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        keys = os.path.join(tmp, "keys.txt")
        with open(keys, "w") as f:
            f.write(cell_keystore(ENCRYPTED))
        wide, records = voice_cell_air(N_CH, FLEET_VOICE_SECONDS, N_CELLS,
                                       keystore=keys, encrypted=ENCRYPTED)
        rx = TetraReceiver(wideband=N_CH, t50=T50, fleet=True, wb_k=WB_K,
                           device=dev, voice=True, keystore=keys)
        sender = {i: _tx_crypto(KeyStore.load(keys), _cell_config(i))
                  for i in ENCRYPTED}
    staged = staged_windows(wide, T50 * N_CH // 2, (T50 - 1) * N_CH // 2
                            + N_CH * CH.TAPS_PER_BRANCH, WB_K, dev)
    del wide
    fixture_s = time.perf_counter() - t0
    fs = N_CH * 25_000
    sb_adv = WB_K * rx._wb["advance"]
    warm = int(WARM_SECONDS * fs / sb_adv) + 1
    check(len(staged) - warm >= 2, f"{len(staged)} superblocks, {warm} "
          f"warm-up")
    trellis, last = SK.trellis, {}

    def spy(x, truncate):
        last["x"], last["truncate"] = x, truncate
        return trellis(x, truncate)

    # the batched decode reaches the kernel through its module reference
    SB.speech_kernel = SimpleNamespace(trellis=spy)
    try:
        blocks = []
        for s in range(warm):
            rx.process_wideband_staged(*staged[s])
            blocks += rx.take_voice()
        ok0 = sum(rx.crc_counts(c)[0] for c in range(N_CH))
        fail0 = sum(rx.crc_counts(c)[1] for c in range(N_CH))
        n_warm_blocks = len(blocks)
        torch.cuda.synchronize()
        trellis.launches = 0
        acelp_launches = AK.synth.launches
        walls = []
        for s in range(warm, len(staged)):
            ts = time.perf_counter()
            rx.process_wideband_staged(*staged[s])
            blocks += rx.take_voice()
            walls.append(time.perf_counter() - ts)
        launches = trellis.launches
        acelp_launches = AK.synth.launches - acelp_launches
    finally:
        SB.speech_kernel = SK
    del staged
    timed = blocks[n_warm_blocks:]
    gates = fleet_gates(rx, ok0, fail0, "slice_voice_fleet")
    check(len(timed) == len(walls) and launches == len(walls)
          and acelp_launches == len(walls),
          f"speech trellis launched {launches} times, ACELP synthesis "
          f"{acelp_launches}, {len(timed)} voice blocks, over {len(walls)} "
          f"superblocks")

    # every delivered row against the air's plaintext, by its call's cell
    truth = [voice_truth(r, 0, len(r)) for r in records]
    index = [{(r.time.mn, r.time.fn, r.time.tn): j
              for j, r in enumerate(recs)} for recs in records]
    ks_cache, seen = {}, {}
    n_rows = n_half = n_bad = 0
    for b in timed:
        for i in range(len(b)):
            c = int(b.carrier[i])
            cell = c % N_CELLS
            key = tuple(int(v) for v in b.time[i, 1:4])
            want = truth[cell].get(key)
            check(want is not None and int(b.timeslot[i]) == VOICE_TS,
                  f"carrier {c} {key}: voice where none was sent")
            half = b.kind[i] == VM.HALF
            check(want[0] == ("frame" if half else "slot"),
                  f"carrier {c} {key}: a {'half' if half else 'slot'} row "
                  f"of a {want[0]} record")
            check(b.crypt[i] == (VM.DECRYPTED if cell in ENCRYPTED
                                 else VM.CLEAR),
                  f"carrier {c} {key}: crypt {b.crypt[i]} after warm-up")
            j = index[cell][key]
            check(j not in seen.setdefault(c, set()),
                  f"carrier {c} {key}: delivered twice")
            seen[c].add(j)
            n_rows += 1
            n_half += int(half)
            if b.bfi[i, 1] or (not half and b.bfi[i, 0]):
                n_bad += 1
                continue
            got = b.frames[i, 1] if half else b.frames[i]
            if half and cell in ENCRYPTED:
                # the fixture sends the surviving frame clear; the monitor
                # XORs the slot's keystream bits 137-273 off it, so XORed
                # with the sender's keystream again it is the sent frame
                if (key, cell) not in ks_cache:
                    ks_cache[key, cell] = sender[cell].keystream_bits(
                        sender[cell].cck, TdmaTime(mn=key[0], fn=key[1],
                                                   tn=key[2]), 274)
                got = got ^ ks_cache[key, cell][137:]
                check(not np.array_equal(b.frames[i, 1], want[1]),
                      f"carrier {c} {key}: half frame not decrypted")
            check(np.array_equal(got, want[1]),
                  f"carrier {c} {key}: codec frames differ from the sent")
    # between a carrier's first and last delivered row, every voice row
    # the air sent was delivered
    missed = 0
    for c, got in seen.items():
        lo, hi = min(got), max(got)
        sent = {index[c % N_CELLS][k] for k in truth[c % N_CELLS]}
        missed += len({j for j in sent if lo <= j <= hi} - got)
    check(missed == 0, f"{missed} voice rows sent and not delivered")
    check(len(seen) > 0.9 * N_CH, f"voice on {len(seen)} of {N_CH} "
          f"carriers")
    check(n_half > 0, "no surviving half delivered")
    check(n_bad <= MAX_BAD_SHARE * n_rows,
          f"{n_bad} bad frames in {n_rows} rows")
    replayed = replay_calls(blocks, np.arange(REPLAY_CARRIERS))

    # the kernel against its plain version on the last superblock's rows
    x, tr = last["x"], last["truncate"]
    R_, T_ = x.shape[0], x.shape[1]
    got = trellis(x, tr)
    check(torch.equal(got, SK.trellis_plain(x, tr)),
          f"speech trellis differs from its plain version at {R_} x {T_}")
    row = dict(name="speech_trellis", rows=R_, steps=T_, max_abs_err=0.0,
               ms=median_ms(lambda: trellis(x, tr), 20),
               plain_ms=median_ms(lambda: SK.trellis_plain(x, tr), 1, 3),
               **trellis_work(R_, T_, 3, R_))
    sb_air = sb_adv / fs
    out = dict(channels=N_CH, superblocks=len(walls), fixture_s=fixture_s,
               rt_margin=sb_air / float(np.mean(walls)),
               sb_air_ms=sb_air * 1e3,
               sb_wall_ms=float(np.mean(walls)) * 1e3, **gates,
               voice_rows=n_rows, halves=n_half, bad_frames=n_bad,
               carriers_with_voice=len(seen), missed=missed,
               pcm_rows_replayed=replayed, trellis_launches=launches,
               trellis_rows=R_, acelp_launches=acelp_launches)
    return out, row


def acelp_batch(rng, keys: np.ndarray):
    """One superblock's synthesis items at the voice cell's shape: the
    calls `keys`, ACELP_ITEMS items spread over them as evenly as the
    cell's (16-17 each, in a seeded interleaving, each call's in time
    order), seeded frames, ~3% surviving halves, ~0.5% bad frames and no
    item withheld (the cell's keys are all held).  Returns (calls, frames,
    bfi, kind)."""
    owner = np.arange(ACELP_ITEMS) % len(keys)
    owner = owner[rng.permutation(ACELP_ITEMS)]
    kind = (rng.random(ACELP_ITEMS) < 0.03).astype(np.int8)
    frames = rng.integers(0, 2, (ACELP_ITEMS, 2, 137)).astype(np.uint8)
    bfi = rng.random((ACELP_ITEMS, 2)) < 0.005
    frames[kind == 1, 0] = 0
    bfi[kind == 1, 0] = False
    return keys[owner], frames, bfi, kind


def acelp_synth_row(dev) -> dict:
    """The ACELP synthesis kernel at the voice cell's shape (ACELP_ITEMS
    items of 768 calls: 256 carriers x timeslots 2-4): ACELP_BATCHES
    successive batches through AcelpCardBank and the host's AcelpBank
    (on cores - 1 threads, as the monitor ran it), PCM equal to the
    sample; then the kernel alone (ms, events), the card bank's whole
    call (call_ms: upload, launch, fetch, copy out; host clock)
    and the host bank's (plain_ms), and the bound: the longest call's
    frames times the synthesis filter's dependent subtractions a frame at
    FP32_LATENCY_CYCLES each, at SM_CLOCK_HZ."""
    rng = np.random.default_rng(23)
    keys = (np.arange(N_CH)[:, None] * 4 + np.arange(1, 4)).reshape(-1)
    host = AcelpBank(threads=max(1, (os.cpu_count() or 2) - 1))
    card = AK.AcelpCardBank(dev)
    err = 0
    for _ in range(ACELP_BATCHES):
        batch = acelp_batch(rng, keys)
        got, want = card.decode(*batch), host.decode(*batch)
        err = max(err, int(np.abs(got.astype(np.int32) - want).max()))
    check(err == 0, f"ACELP synthesis on the card differs from the host "
          f"codec by {err} LSB")
    calls, frames, bfi, kind = batch
    order, seg, ks = AK.plan(calls)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        frames, bfi.astype(np.uint8), kind, order, seg, ks)]
    pcm = torch.empty((len(calls), AK.PCM), dtype=torch.int16, device=dev)
    ms = median_ms(lambda: AK.synth(*args, card._pool, None, pcm), 5)

    def wall_ms(bank, n):
        times = []
        for _ in range(n):
            batch = acelp_batch(rng, keys)
            t0 = time.perf_counter()
            bank.decode(*batch)
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    call_ms, plain_ms = wall_ms(card, 10), wall_ms(host, 3)
    frames_longest = int((np.diff(seg) * 2).max())
    bound_ms = (frames_longest * SYNTH_CHAIN_OPS * FP32_LATENCY_CYCLES
                / SM_CLOCK_HZ * 1e3)
    return dict(name="acelp_synth", calls=len(ks), items=len(calls),
                max_abs_err=float(err), ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="serial chain", frames_longest_call=frames_longest,
                bytes=int(frames.nbytes + bfi.nbytes + pcm.numel() * 2))


def decode_slot_device_ops(dev) -> dict:
    """Device operations one decode_slot call issues (B = 1, as the
    pipeline calls it): the profiler's device rows over one call."""
    frames = np.random.default_rng(3).integers(0, 2, (2, 137)).astype(
        np.uint8)
    type4 = VCH.encode_slot(frames.reshape(-1))[None]
    VCH.decode_slot(type4, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got, bfi = VCH.decode_slot(type4, device=dev)
        torch.cuda.synchronize()
    check(np.array_equal(got[0], frames) and not bfi[0],
          "decode_slot under the profiler")
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(device_ops=sum(e.count for e in rows),
                device_ms=sum(_device_ms(e) for e in rows),
                memcpy_ops=sum(e.count for e in rows
                               if "memcpy" in e.key.lower()))


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, which counts its launches."""
    return {"K1 agc_fll_rrc": DK.agc_fll_rrc, "K2 mm_costas": MK.mm_costas,
            "K3 fold_dft_resample": CK.fold_dft_resample,
            "K4 fold_dft": CK.fold_dft}


def zero_launches() -> dict:
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def read_launches(wrappers: dict) -> dict:
    return {name: w.launches for name, w in wrappers.items()}


def run_mode(dev, iq: np.ndarray, mode: str, seconds: float,
             n_ch: int) -> tuple[dict, TetraReceiver]:
    """TetraReceiver(n_ch, mode=mode) over the first `seconds` of the
    36 kHz channels iq (n_ch, T) in MODES_BLOCK blocks, timed per block
    after WARM_SECONDS, with the decode gates and no kernel launched."""
    B = MODES_BLOCK
    n_blk = int(seconds * 36_000) // B
    warm = int(WARM_SECONDS * 36_000 / B) + 1
    check(n_blk - warm >= 3, f"{mode}: {n_blk} blocks, {warm} warm-up")
    rx = TetraReceiver(n_ch, mode=mode, events=False, device=dev)
    res = drive_receiver(
        rx, rx.process, [iq[:, k * B:(k + 1) * B] for k in range(n_blk)],
        warm, n_ch, mode, "block",
        [(rx.demod, "demod_block", "demod (ops issued + fetch)"),
         (TetraReceiver, "_fetch", "demod (ops issued + fetch)"),
         *DECODE_STAGES], "rest (slicing, dibit unpacking, quality)")
    del res["inner"]
    check(not any(res["launches"].values()),
          f"{mode}: the receiver launched kernels {res['launches']}")
    air_ms = B / 36.0
    return dict(res, mode=mode, channels=n_ch, block=B, blocks_driven=n_blk,
                block_air_ms=air_ms,
                rt_margin=air_ms / res["block_wall_ms"]), rx


def agreement(got: dict, ref: dict, tol: float) -> dict:
    """Two demod outputs (on the CPU): the share of channels with identical
    dibits and valid, and on those channels' valid slots the largest
    symbol/dist difference and the share within tol."""
    same = ((got["dibits"] == ref["dibits"]).all(dim=1)
            & (got["valid"] == ref["valid"]).all(dim=1))
    v = ref["valid"] & same[:, None]
    diff = torch.stack([(got[k] - ref[k]).abs()[v]
                        for k in ("sym_re", "sym_im", "dist")])
    return dict(channels_identical=float(same.float().mean()),
                max_abs_err=float(diff.max()),
                share_within_tol=float((diff <= tol).float().mean()))


def card_vs_cpu(mode: str, mod, state, block: np.ndarray) -> dict:
    """One block through a demod chain from the same state on the card and
    on the CPU, held to TOL_MODES_CHANNELS and TOL_MODES_FLOAT; and the
    control, the CPU run on the block rounded to float16, which the float
    check must fail for the modes in CONTROL_FAILS."""
    fields = convert.state_to_numpy(state)

    def on_cpu(x):
        cpu = convert.state_from_numpy(fields, "cpu", type(state))
        return mod.demod_block(cpu, x)[1]
    _, og = mod.demod_block(state, block)
    oc = on_cpu(block)
    tol, need, cap = TOL_MODES_FLOAT[mode]
    res = agreement({k: v.cpu() for k, v in og.items()}, oc, tol)
    check(res["channels_identical"] >= TOL_MODES_CHANNELS,
          f"{mode}: card and CPU agree on {res['channels_identical']:.4f} "
          f"of channels")
    check(res["share_within_tol"] >= need and res["max_abs_err"] <= cap,
          f"{mode}: card vs CPU floats within {tol} on "
          f"{res['share_within_tol']:.4f} of the slots (max "
          f"{res['max_abs_err']}, limit {cap})")
    half = (block.real.astype(np.float16).astype(np.float32)
            + 1j * block.imag.astype(np.float16).astype(np.float32))
    control = agreement(on_cpu(half.astype(np.complex64)), oc, tol)
    if mode in CONTROL_FAILS:
        check(control["share_within_tol"] < need,
              f"{mode}: the float16 control passes the float check "
              f"({control})")
    return dict(res, tol=tol, share_needed=need, max_allowed=cap,
                float16_control=control)


def run_clis(jobs: dict) -> dict:
    """Each job {name: (app, *args)} as `python -m tetra_tpu_torch.apps.<app>
    args` on the card (the apps' default device), from this checkout, all
    started together (two host threads each; they share the card and the
    host's cores, so each wall includes the others' load).  Returns {name:
    (its last stdout line as JSON, its wall time)}; any failure raises."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2")
    with tempfile.TemporaryDirectory() as tmp:
        logs = {name: [open(os.path.join(tmp, f"{name}.{k}"), "w+")
                       for k in ("out", "err")] for name in jobs}
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", f"tetra_tpu_torch.apps.{app}",
             *map(str, args)], cwd=root, env=env, stdout=logs[name][0],
            stderr=logs[name][1]) for name, (app, *args) in jobs.items()}
        walls = {}
        try:
            while len(walls) < len(procs):
                check(time.perf_counter() - t0 < 300, f"CLI jobs "
                      f"{sorted(set(procs) - set(walls))} over 300 s")
                for name, proc in procs.items():
                    if name not in walls and proc.poll() is not None:
                        walls[name] = time.perf_counter() - t0
                time.sleep(0.05)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        out = {}
        for name, (fo, fe) in logs.items():
            fo.seek(0)
            fe.seek(0)
            stdout, stderr = fo.read(), fe.read()
            fo.close()
            fe.close()
            check(procs[name].returncode == 0,
                  f"{name} {jobs[name]} failed:\n{stderr[-2000:]}")
            out[name] = (json.loads(stdout.strip().splitlines()[-1]),
                         walls[name])
    return out


def cli_round_trip(dev) -> dict:
    """tetra_tx -> tetra_rx as subprocesses on the card: a 1-channel capture
    decoded by each --demod, an 8-carrier wideband one by --demod ff (the
    two captures written together, then the four decodes run together).
    At 8 channels K4 takes its matrix-DFT kernel (fold_dft_kernel), which
    is held here against its plain version on that capture's rows while
    the decodes run."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        one, wide = os.path.join(tmp, "dl.cf32"), os.path.join(tmp, "wb.cf32")
        tx = run_clis({
            "tetra_tx": ("tetra_tx", one, "--slots", CLI_SLOTS, "--mcc",
                         "901", "--mnc", "4321", "--cc", "13", "--cfo",
                         "250", "--snr", "28"),
            "tetra_tx_wideband": ("tetra_tx", wide, "--slots", "220",
                                  "--wideband", "8", "--channels", "0,3,5",
                                  "--mcc", "310", "--mnc", "77")})
        out.update({f"{k}_s": wall for k, (_, wall) in tx.items()})
        jobs = {f"tetra_rx_{mode}": ("tetra_rx", one, "--demod", mode,
                                     "--status-every", "100")
                for mode in ("fast", "ff", "exact")}
        jobs["tetra_rx_wideband_ff"] = ("tetra_rx", wide, "--wideband", "8",
                                        "--demod", "ff", "--status-every",
                                        "100")
        z = k4_rows(load_iq(wide), 8, dev)
        _, err, rms = k4_check(z[0], z[1], 8, CK.fold_dft(z[0], z[1], 8))
        out["k4_n_ch8"] = dict(rows=int(z[0].shape[0]), max_abs_err=err,
                               rms=rms)
        del z
        rx = run_clis(jobs)
        for mode in ("fast", "ff", "exact"):
            summary, wall = rx[f"tetra_rx_{mode}"]
            s = summary[0]
            check(s["locked"] and (s["mcc"], s["mnc"]) == (901, 4321),
                  f"tetra_rx --demod {mode}: {s}")
            out[f"tetra_rx_{mode}"] = dict(wall_s=wall, crc_ok=s["crc_ok"],
                                          crc_fail=s["crc_fail"])
        summary, wall = rx["tetra_rx_wideband_ff"]
        cells = {s["channel"]: s for s in summary if s["channel"] in (0, 3, 5)}
        check(all(s["locked"] and (s["mcc"], s["mnc"]) == (310, 77)
                  for s in cells.values()) and len(cells) == 3,
              f"tetra_rx --wideband 8 --demod ff: {summary}")
        out["tetra_rx_wideband_ff"] = dict(
            wall_s=wall, crc_ok=[cells[c]["crc_ok"] for c in (0, 3, 5)])
    return out


def phase_slice_modes(dev, wide: np.ndarray, n_ch: int = N_CH) -> dict:
    """The CLI's --wideband N --demod ff/exact host path in process, card
    against CPU from a warm state, then the CLI round trip.  Returns the
    phase's results and (state, block) per mode for the device-op count."""
    fs = n_ch * 25_000
    # the air as an SDR capture at full scale (peak |x| = 1, as load_iq
    # returns a cs16 file): the exact chain's per-sample AGC (gain +=
    # 0.02 (1 - |y|)) is stable only for |x| < 2 / 0.02 = 100, and the
    # channelizer's gain of n_ch takes cell_air's unit carriers to ~400
    # at 256 channels, where the reference's chain diverges too
    air = wide[:int(max(MODES_SECONDS.values()) * fs)]
    air = (air / np.abs(air).max()).astype(np.complex64)
    wrappers = zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ch = CH.channelize(air, n_ch, dev)
    t1 = time.perf_counter()
    iq = CH.resample_50_to_36(ch, dev)
    t2 = time.perf_counter()
    front = read_launches(wrappers)
    check(front["K4 fold_dft"] == 1, f"channelize launched K4 "
          f"{front['K4 fold_dft']} times, not once over the capture")
    check(not any(n for k, n in front.items() if k != "K4 fold_dft"),
          f"the host front end launched {front}")
    # K4's one launch at this size (~28x the main path's rows) against its
    # plain version on the same rows
    z = k4_rows(air, n_ch, dev)
    yk = [torch.from_numpy(np.ascontiguousarray(p.T)).to(dev)
          for p in (ch.real, ch.imag)]
    _, err, rms = k4_check(z[0], z[1], n_ch, yk)
    out = dict(channels=n_ch, air_s=len(air) / fs, channelize_ms=(t1 - t0)
               * 1e3, resample_ms=(t2 - t1) * 1e3, frames_50k=ch.shape[1],
               samples_36k=iq.shape[1], launches=front,
               k4_rows=int(z[0].shape[0]), k4_max_abs_err=err, k4_rms=rms)
    del ch, z, yk
    warm = {}
    for mode, seconds in MODES_SECONDS.items():
        out[mode], rx = run_mode(dev, iq, mode, seconds, n_ch)
        block = iq[:, -MODES_BLOCK:] if mode == "ff" else \
            iq[:, out[mode]["blocks_driven"] * MODES_BLOCK:
               (out[mode]["blocks_driven"] + 1) * MODES_BLOCK]
        out[mode]["card_vs_cpu"] = card_vs_cpu(mode, rx.demod, rx.state,
                                                block)
        warm[mode] = (rx.state, block)
    out["cli"] = cli_round_trip(dev)
    return out, warm


def exact_device_ops(state, block: np.ndarray) -> dict:
    """Device operations of the exact chain over the first
    EXACT_PROFILED samples of a block (C = 256): the profiler's device
    rows over one demod_block call (the chain steps sample by sample, so
    its ops grow with the samples; the profiler adds ~0.5 ms of host time
    to each)."""
    from tetra_tpu_torch.rx import demod as EX
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        EX.demod_block(state, block[:, :EXACT_PROFILED])
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(samples=EXACT_PROFILED,
                device_ops=sum(e.count for e in rows),
                device_ms=sum(_device_ms(e) for e in rows))

def decrypted_sdus(events) -> int:
    """The decrypted SDS messages in an event log (LLC events whose
    MLE/SDS parse succeeded on an encrypted cell)."""
    return sum(e[0] == "llc" and e[2].name == "BL-UDATA"
               and e[3] is not None and e[3].pdu_name == "D-SDS DATA"
               for e in events)


def phase_slice_pool(dev, wide: np.ndarray, nf_rx) -> dict:
    """The per-channel receiver with its MAC in POOL_WORKERS CPU worker
    processes (TetraReceiver(..., mac_workers=W), the CLI's --mac-workers
    W) on slice_nonfleet's air and warm-up: the decode gates, every
    kernel launched, and per channel the display and CRC tallies of the
    in-process receiver nf_rx on the same air; then pool_voice."""
    t0 = time.perf_counter()
    rx = TetraReceiver(wideband=N_CH, t50=T50, events=False,
                       mac_workers=POOL_WORKERS, device=dev)
    spawn_s = time.perf_counter() - t0
    try:
        check(rx.pool is not None and not rx.mac and rx.device_acquire,
              "the pooled receiver has no in-process MAC")
        chunks, warm = cycle_chunks(rx, wide, NONFLEET_SECONDS)
        res = drive_receiver(
            rx, rx.process_wideband, chunks, warm + 1, N_CH, "pooled",
            "cycle", [(R, "_wideband_step", "device step + fetch"),
                      (TetraReceiver, "_fetch", "device step + fetch"),
                      (TetraReceiver, "_sync_bursts",
                       "burst sync + device acquire"),
                      (LM, "decode_bursts_multi", "FEC"),
                      (MacPool, "_recv", "wait for the workers")],
            "rest (framing, upload, shipping to the workers)")
        del res["inner"]
        for name, n in res["launches"].items():
            check(n > 0, f"{name} was not launched on the pooled path")
        differ = [c for c in range(N_CH)
                  if rx.display(c).as_dict() != nf_rx.display(c).as_dict()
                  or rx.crc_counts(c) != nf_rx.crc_counts(c)]
        check(not differ, f"pooled decode differs from the in-process "
              f"receiver's on channels {differ[:20]}")
    finally:
        rx.pool.close()
    n_cyc = len(chunks) - 1
    air_ms = rx._wb["advance"] / (N_CH * 25_000) * 1e3
    return dict(res, channels=N_CH, workers=POOL_WORKERS,
                spawn_s=spawn_s, cycles_driven=n_cyc, cycle_air_ms=air_ms,
                rt_margin=air_ms / res["cycle_wall_ms"],
                launches_per_cycle={k: v / n_cyc
                                    for k, v in res["launches"].items()},
                channels_equal_to_in_process=N_CH, voice=pool_voice(dev))


def pool_voice(dev) -> dict:
    """voice_cell_air at POOL_VOICE_CARRIERS carriers through a pool of
    POOL_WORKERS with voice=True and a keystore (the workers decode voice
    on the CPU), against the same receiver in process with one
    VoicePipeline on the card and one CryptoState from the keystore per
    carrier, fed the same chunks in lockstep.  Each cycle's
    pool.take_audio() must be the in-process PCM in the pool's batch
    order (workers in the order their first channel came, each's channels
    in order), and every carrier's decrypted-SDU count the in-process
    count."""
    with tempfile.TemporaryDirectory() as tmp:
        keys = os.path.join(tmp, "keys.txt")
        with open(keys, "w") as f:
            f.write(cell_keystore(ENCRYPTED))
        return _pool_voice(dev, keys)


def _pool_voice(dev, keys: str) -> dict:
    n, W = POOL_VOICE_CARRIERS, POOL_WORKERS
    wide, _ = voice_cell_air(n, POOL_VOICE_SECONDS, N_CELLS, keystore=keys,
                             encrypted=ENCRYPTED)
    local = TetraReceiver(wideband=n, t50=T50, events=True, device=dev)
    pipes = []
    for m in local.mac:
        m.upper.crypto_state = CryptoState(store=KeyStore.load(keys))
        pipes.append(VoicePipeline(crypto_state=m.upper.crypto_state,
                                   device=dev))
        m.voice_cb = pipes[-1]
    t0 = time.perf_counter()
    pooled = TetraReceiver(wideband=n, t50=T50, events=True, mac_workers=W,
                           voice=True, keystore=keys, device=dev)
    spawn_s = time.perf_counter() - t0
    batches, differ, walls, pcm_samples = [], [], {"pool": [], "local": []}, 0
    sync = pooled._sync_bursts

    def recorded(feeds):
        out = sync(feeds)
        batches.append(list(out[0]))
        return out

    pooled._sync_bursts = recorded
    try:
        chunks, _ = cycle_chunks(pooled, wide, POOL_VOICE_SECONDS)
        for k, chunk in enumerate(chunks):
            t0 = time.perf_counter()
            local.process_wideband(chunk)
            per = [vp.take_audio() for vp in pipes]
            t1 = time.perf_counter()
            batches.clear()
            pooled.process_wideband(chunk)
            got = pooled.pool.take_audio()
            walls["local"].append(t1 - t0)
            walls["pool"].append(time.perf_counter() - t1)
            ids = batches[0] if batches else []
            want = [per[c] for w in dict.fromkeys(c % W for c in ids)
                    for c in ids if c % W == w]
            want = np.concatenate(want) if want else np.zeros(0, np.int16)
            pcm_samples += len(want)
            if not np.array_equal(got, want) or sum(map(len, per)) != len(
                    want):
                differ.append(dict(cycle=k, carriers=[
                    c for c in range(n) if len(per[c])]))
        sdus = [(decrypted_sdus(pooled.pool.views[c].events),
                 decrypted_sdus(local.mac[c].upper.events))
                for c in range(n)]
    finally:
        pooled.pool.close()
    check(not differ, f"pooled voice PCM differs from the in-process PCM "
          f"(CPU workers vs the card) in cycles {differ}")
    check(pcm_samples >= 480 * 10 * n, f"only {pcm_samples} PCM samples")
    check(all(a == b for a, b in sdus) and sum(a for a, _ in sdus) > 0,
          f"decrypted SDUs per carrier, pooled vs in-process: {sdus}")
    check(all(pooled.locked(c) for c in range(n)),
          "a pooled voice carrier is unlocked")
    return dict(carriers=n, workers=W, air_s=POOL_VOICE_SECONDS,
                spawn_s=spawn_s, cycles=len(chunks) - 1,
                pcm_samples=pcm_samples,
                decrypted_sdus=sum(a for a, _ in sdus),
                cycle_ms_pool=float(np.mean(walls["pool"][1:])) * 1e3,
                cycle_ms_in_process=float(np.mean(walls["local"][1:]))
                * 1e3)


def phase_slice_mesh(dev, wide: np.ndarray) -> dict:
    """(a) The mesh's superblock step on a 1x1 (host, chip) mesh in this
    process (one gloo rank): MESH_SUPERBLOCKS superblocks of the fleet
    slice's staged air at n_ch = 256, wb_k = 8 (K4 over the band, the
    resample kernel alone, K1, K2 lean), its launches counted over those
    steps alone; then its packed words against _wideband_step_scan on the
    same windows (K3 in one call): rows [:-1] equal, the dist-sum row
    within 2e-3 relative, and the all-reduced health equal to the sums of
    its own rows.  (b) The multihost launcher's one-card rehearsal as a
    subprocess: 2 hosts x 1 chip, two gloo ranks on this card, 256
    channels a host, --selftest; both hosts must print SELFTEST PASS."""
    import torch.distributed as dist

    from tetra_tpu_torch.parallel import mesh as M

    t36 = T50 * 18 // 25
    n_chunks = DF.n_chunks_for(t36)
    with tempfile.TemporaryDirectory() as tmp:
        M.init_distributed("gloo", "file://" + os.path.join(tmp, "rdv"), 1,
                           0, dev)
        try:
            mesh = M.make_mesh_2d(1, 1, dev)
            step, wide_len, adv = M.sharded_wideband_superblock_step(
                mesh, N_CH, t50_new=T50, kw=WB_K)
            staged = staged_windows(wide, adv, wide_len, WB_K,
                                    dev)[:MESH_SUPERBLOCKS]
            state = M.sharded_wideband_demod_init(mesh, N_CH, dev)
            torch.cuda.synchronize()
            wrappers = zero_launches()
            CK.resample.launches = 0
            t0 = time.perf_counter()
            outs = []
            for wr, wi in staged:
                state, out, health, c0 = step(state, wr, wi)
                outs.append((out, health, c0))
            torch.cuda.synchronize()
            mesh_ms = (time.perf_counter() - t0) * 1e3 / len(staged)
            launches = read_launches(wrappers)
            launches["resample (K3's second kernel)"] = CK.resample.launches
        finally:
            dist.destroy_process_group()
    for name in ("K1 agc_fll_rrc", "K2 mm_costas", "K4 fold_dft",
                 "resample (K3's second kernel)"):
        check(launches[name] == WB_K * len(staged),
              f"mesh: {name} launched {launches[name]} times")
    check(launches["K3 fold_dft_resample"] == 0,
          "mesh: K3 launched as one call")
    dstate = DF.demod_init(N_CH, dev)
    hr = hi = torch.zeros((CH.RS_TAPS_PER_PHASE - 1, N_CH), device=dev)
    dist_err = 0.0
    for (wr, wi), (out, health, c0) in zip(staged, outs):
        dstate, ref, hr, hi = R._wideband_step_scan(
            dstate, wr, wi, hr, hi, N_CH, t36, n_chunks, False, WB_K)
        check(c0 == 0 and torch.equal(out[:-1], ref[:-1]),
              "mesh superblock words differ from _wideband_step_scan's")
        d, r = (x[-1].view(torch.float32).double() for x in (out, ref))
        dist_err = max(dist_err, float(((d - r).abs()
                                        / r.abs().clamp(min=1e-30)).max()))
        want = torch.stack([out[-2].view(torch.float32).double().sum(),
                            d.sum()])
        check(bool(torch.allclose(health.double(), want, rtol=1e-5)),
              f"mesh health {health} vs its rows' sums {want}")
    check(dist_err <= 2e-3, f"mesh dist-sum row off by {dist_err} "
          f"relative")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "tetra_tpu_torch.apps.multihost", "--hosts",
         "2", "--chips", "1", "--channels", str(N_CH), "--selftest",
         "--backend", "gloo", "--status-every", "0"], cwd=root, env=env,
        capture_output=True, text=True, timeout=400)
    wall = time.perf_counter() - t0
    lines = res.stdout.splitlines()
    check(res.returncode == 0 and "mesh (host=2, chip=1)" in res.stdout
          and all(f"[host {h}] SELFTEST PASS" in lines for h in range(2)),
          f"multihost rehearsal failed (rc {res.returncode}):\n"
          f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    rates = [float(ln.split(" MS/s/host")[0].rsplit(" ", 1)[1])
             for ln in lines if " done: " in ln]
    return dict(superblocks=len(staged), wb_k=WB_K, channels=N_CH,
                superblock_ms=mesh_ms, launches=launches,
                dist_row_max_rel_err=dist_err,
                multihost=dict(hosts=2, chips=1, backend="gloo",
                               wall_s=wall, msps_per_host=rates,
                               lines=[ln for ln in lines if "done:" in ln
                                      or "SELFTEST" in ln or "mesh" in ln]))



def marginal_bands(plan: dict) -> list:
    """slice_marginal's SNR bands: (label, carriers) per 1 dB of the
    marginal sweep, then the handover carriers."""
    snr, ho = plan["snr_db"], plan["handover"]
    lo, hi = MARGINAL_SNR_DB
    edges = list(np.arange(lo, hi, 1.0)) + [hi + 1e-9]
    bands = [(f"{a:g}-{min(b, hi):g} dB", np.nonzero(
        (snr >= a) & (snr < b) & ~ho)[0]) for a, b in zip(edges, edges[1:])]
    return bands + [("handover", np.nonzero(ho)[0])]


def marginal_card_vs_cpu(state, hist: tuple, sb: tuple, gate=check) -> dict:
    """One superblock of the fleet receiver's windows sb from its warm
    state and resampler history, cycle by cycle on the card and on the
    CPU, each cycle from the card's state: K3 within TOL_FRONT_REL of the
    plain version's RMS; the chain (K3, K1, K2) with valid identical and
    dibits identical on >= TOL_MARGINAL_CHAIN_CHANNELS of the channels;
    K2 on the card K1's output against its plain version on the CPU on
    the same input under k2_check's marginal-SNR rule
    (axis_eps=K2_AXIS_EPS).  K1's mf error is recorded, not gated: its
    2e-4 limit is known along one warm trajectory at 25 dB only (ROADMAP
    Queue 3).  gate(cond,
    what) raises on a failed check (check) or records it.  Returns the
    readings per cycle."""
    t36 = T50 * 18 // 25
    n_chunks = DF.n_chunks_for(t36)
    cpu = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t
    hr, hi = hist
    out = dict(cycles=[], leak_switch_channels=0, axis_switch_channels=0)
    for j in range(WB_K):
        wr, wi = sb[0][j], sb[1][j]
        rr, ri, hr2, hi2 = CH._front_end_block(wr, wi, hr, hi, N_CH, t36)
        pr, pi, _, _ = CH._front_end_block(cpu(wr), cpu(wi), cpu(hr),
                                           cpu(hi), N_CH, t36)
        rms = float(torch.sqrt((pr ** 2 + pi ** 2).mean()))
        err3 = max(maxerr(rr.cpu(), pr), maxerr(ri.cpu(), pi))
        gate(err3 <= TOL_FRONT_REL * rms, f"slice_marginal cycle {j}: K3 "
             f"error {err3} vs rms {rms}")
        st = {k: cpu(v) for k, v in state._asdict().items()}
        k1 = DK.agc_fll_rrc(rr.contiguous(), ri.contiguous(),
                            state.agc_gain, state.fll_phase, state.fll_freq,
                            state.fll_hist_re.T.contiguous(),
                            state.fll_hist_im.T.contiguous())
        k1p = DK.agc_fll_rrc(pr.contiguous(), pi.contiguous(),
                             st["agc_gain"], st["fll_phase"], st["fll_freq"],
                             st["fll_hist_re"].T.contiguous(),
                             st["fll_hist_im"].T.contiguous())
        err1 = max(maxerr(k1[0].cpu(), k1p[0]), maxerr(k1[1].cpu(), k1p[1]))
        zero = torch.zeros_like(st["mm_pos"])
        st0 = torch.stack([st["mm_pos"], st["mm_omega"], st["cos_phase"],
                           st["cos_freq"], st["cos_ph2"],
                           st["prev_sym"].to(torch.float32), zero, zero])
        kw = dict(emit_syms=True, tail_re=st["mm_tail_re"].T.contiguous(),
                  tail_im=st["mm_tail_im"].T.contiguous())
        k2 = MK.mm_costas(k1[0], k1[1], st0.to(rr.device), n_chunks,
                          **{k: v.to(rr.device) if isinstance(v, torch.Tensor)
                             else v for k, v in kw.items()})
        p2 = MK.mm_costas_plain(k1p[0], k1p[1], st0, n_chunks, **kw)
        vk, vp = k2[3].cpu().bool(), p2[3].bool()
        same = ((vk == vp) & ((k2[2].cpu() == p2[2]) | ~vk)).all(dim=0)
        chain = float(same.float().mean())
        gate(chain >= TOL_MARGINAL_CHAIN_CHANNELS and bool(
            (vk == vp).all()), f"slice_marginal cycle {j}: chain dibits/"
             f"valid identical on {chain:.4f} of channels")
        alone = k2_check(k2, (k1[0].cpu(), k1[1].cpu(), st0, n_chunks), kw,
                         n_chunks, f"slice_marginal cycle {j}: K2", gate,
                         axis_eps=K2_AXIS_EPS)
        by = [v["by"] for v in alone["switched"].values()]
        out["leak_switch_channels"] += by.count("leak")
        out["axis_switch_channels"] += by.count("axis")
        out["cycles"].append(dict(
            k3_max_abs_err=err3, k3_rms=rms, k1_mf_max_abs_err=err1,
            chain_channels_identical=chain,
            **{f"k2_{k}": alone[k] for k in (
                "channels_identical", "channels_identical_kept",
                "max_abs_err", "max_abs_err_kept", "switched",
                "unexplained")}))
        state = DF._demod_block_impl(state, rr.T, ri.T, n_chunks)[0]
        hr, hi = hr2, hi2
    cyc = out["cycles"]
    out.update({f"{k}_{m}": f(c[k] for c in cyc) for k, m, f in (
        ("chain_channels_identical", "min", min),
        ("k2_channels_identical", "min", min),
        ("k2_channels_identical_kept", "min", min),
        ("k2_max_abs_err_kept", "max", max),
        ("k1_mf_max_abs_err", "max", max))},
        k3_max_rel_err=max(c["k3_max_abs_err"] / c["k3_rms"] for c in cyc))
    return out


def phase_slice_marginal(dev) -> dict:
    """256 carriers at marginal SNR (tx.wideband.marginal_air:
    MARGINAL_SNR_DB over 7 carriers in 8, every 8th at 25 dB dropping out
    at MARGINAL_DROPOUT_AT and coming back as another cell), through the
    fleet receiver TetraReceiver(wideband=256, t50=6400, fleet=True,
    wb_k=8) fed staged superblocks, and the per-channel TetraReceiver(
    wideband=256,
    t50=6400, events=False, device_acquire=False) and a one-cycle fleet
    receiver (wb_k=1) fed the same cycles as host cf32, one a call.
    Gates: every carrier's state equal in the one-cycle fleet and the
    per-channel receiver (rx/parity.channel_mismatches); the superblock
    fleet's (after flush_wideband) equal to theirs but, on channels whose
    CRC tallies differ, in what decoded blocks set (DECODE_FIELDS): the
    scope of the scrambling adoption's re-decode differs
    (rx/fleet.FleetEngine._decode_dispatch re-decodes the rows of the
    whole call, here 8 cycles, under a channel's newly adopted code, rows
    before the adopting SYNC PDU included; the per-channel path does the
    same per cycle, LowerMac.decode_bursts_multi); no carrier
    adopts a cell (a CRC-checked SYNC PDU: the engine's cell and
    scrambling code) other than its own or, on a handover carrier, the
    new one; every handover carrier lost lock and ends locked on its new
    cell with its scrambling code; per SNR band, a share of the carriers
    on their own cell (MARGINAL_OWN_SHARE); K1-K4 launched WB_K times a
    superblock and once a cycle; then marginal_card_vs_cpu from the fleet
    receiver's state MARGINAL_CARD_VS_CPU_AT superblocks in.  The display
    takes every SYNC PDU's fields, CRC or not (the reference's
    tetra_lower_mac.c behaviour), so carriers showing another cell there
    are counted, not gated."""
    from tetra_tpu_torch.rx.parity import channel_mismatches
    from tetra_tpu_torch.tx.wideband import handover_cell, marginal_air

    t_phase = time.perf_counter()
    wide, plan = marginal_air(N_CH, MARGINAL_SECONDS, MARGINAL_DROPOUT_AT,
                              device=dev)
    fixture_s = time.perf_counter() - t_phase
    fs = N_CH * 25_000
    rx_f = TetraReceiver(wideband=N_CH, t50=T50, fleet=True, wb_k=WB_K,
                         device=dev)
    rx_p = TetraReceiver(wideband=N_CH, t50=T50, events=False,
                         device_acquire=False, device=dev)
    rx_1 = TetraReceiver(wideband=N_CH, t50=T50, fleet=True, device=dev)
    adv, wl = rx_f._wb["advance"], rx_f._wb["wide_len"]
    staged = staged_windows(wide, adv, wl, WB_K, dev)
    n_sb = len(staged)
    check(n_sb > MARGINAL_CARD_VS_CPU_AT, f"{n_sb} superblocks")
    wrappers = zero_launches()
    walls_f, per_sb, snap = [], [], None
    for s, sb in enumerate(staged):
        if s == MARGINAL_CARD_VS_CPU_AT:
            snap = (rx_f.state, (rx_f._wb["hist_r"], rx_f._wb["hist_i"]), sb)
        before = read_launches(wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rx_f.process_wideband_staged(*sb)
        walls_f.append(time.perf_counter() - t0)
        per_sb.append({k: n - before[k]
                       for k, n in read_launches(wrappers).items()})
    rx_f.flush_wideband()
    launches = read_launches(wrappers)
    check(all(n == WB_K for d in per_sb for n in d.values()),
          f"slice_marginal fleet launches per superblock: {per_sb}")
    # the per-channel receiver and the one-cycle fleet: the same cycles,
    # one a call
    head = [wide[:wl - adv]] + [wide[wl - adv + k * adv:wl + k * adv]
                                for k in range(n_sb * WB_K)]
    ho = np.nonzero(plan["handover"])[0]
    new = {int(c): handover_cell(int(plan["new_cell"][c])) for c in ho}
    relock = {}
    back = plan["dropout"][1]
    walls_p, walls_1, bad_cycles = [], [], []
    wrappers = zero_launches()
    for k, chunk in enumerate(head):
        before = read_launches(wrappers)
        t0 = time.perf_counter()
        rx_p.process_wideband(chunk)
        walls_p.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        rx_1.process_wideband(chunk)
        walls_1.append(time.perf_counter() - t0)
        got = read_launches(wrappers)
        if k and any(got[n] - before[n] != 2 for n in got):
            bad_cycles.append(k)
        end_s = (wl - adv + k * adv) / fs if k else 0.0
        for c in ho:
            d = rx_p.display(c)
            if c not in relock and end_s > back and rx_p.locked(c) and (
                    d.mcc, d.mnc, d.cc) == (new[c].mcc, new[c].mnc,
                                             new[c].cc):
                relock[int(c)] = end_s - back
    launches_p = read_launches(wrappers)
    check(not bad_cycles, f"slice_marginal cycles without one launch of "
          f"each kernel by each receiver: {bad_cycles[:10]}")
    for name in launches:
        launches[name] += launches_p[name]
    # gates
    t0 = time.perf_counter()
    differ = {c: m for c in range(N_CH)
              if (m := channel_mismatches(rx_1, rx_p, c))}
    check(not differ, f"slice_marginal: one-cycle fleet vs per-channel "
          f"state differs on {len(differ)} channels: "
          f"{dict(list(differ.items())[:8])}")
    differ8 = {c: m for c in range(N_CH)
               if (m := channel_mismatches(rx_f, rx_p, c))}
    check(all("crc_counts" in m and set(m) <= DECODE_FIELDS
              for m in differ8.values()),
          f"slice_marginal: superblock fleet vs per-channel state differs "
          f"beyond what the CRC tallies carry: "
          f"{dict(list(differ8.items())[:8])}")
    crc_scope = {c: dict(superblock=rx_f.crc_counts(c),
                         cycle=rx_1.crc_counts(c)) for c in differ8}
    parity_s = time.perf_counter() - t0
    own = lambda c: (262, 100 + int(plan["cell"][c]),
                     1 + int(plan["cell"][c]))
    false_cell, display_other, own_cell = [], [], set()
    for c in range(N_CH):
        ch = rx_f.fleet.chan(c)
        cell = (ch.cell_mcc, ch.cell_mnc, ch.cell_cc)
        mine = [own(c), (0, 0, 0)]
        if c in new:
            mine.append((new[c].mcc, new[c].mnc, new[c].cc))
        if cell not in mine:
            false_cell.append((c, cell))
        if cell == own(c):
            own_cell.add(c)
        d = rx_f.display(c)
        if (d.mcc, d.mnc, d.cc) not in mine:
            display_other.append(c)
    check(not false_cell, f"slice_marginal: carriers adopted a cell not "
          f"their own: {false_cell[:8]}")
    ho_fail = []
    for c, cfg in new.items():
        ch = rx_f.fleet.chan(c)
        d = rx_f.display(c)
        if not (rx_f.fleet.lock_losses(c) >= 1 and rx_f.locked(c)
                and (ch.cell_mcc, ch.cell_mnc, ch.cell_cc)
                == (d.mcc, d.mnc, d.cc) == (cfg.mcc, cfg.mnc, cfg.cc)
                and int(rx_f.fleet.scramb[c])
                == P.scramb_get_init(cfg.mcc, cfg.mnc, cfg.cc)):
            ho_fail.append(c)
    check(not ho_fail, f"slice_marginal: handover carriers not relocked on "
          f"their new cell: {ho_fail}")
    bands = {}
    for label, cs in marginal_bands(plan):
        oks = sum(rx_f.crc_counts(int(c))[0] for c in cs)
        fails = sum(rx_f.crc_counts(int(c))[1] for c in cs)
        bands[label] = dict(
            carriers=len(cs),
            locked_share=float(np.mean([rx_f.locked(int(c)) for c in cs])),
            own_cell_share=float(np.mean([int(c) in own_cell for c in cs])),
            crc_ok=int(oks), crc_fail=int(fails))
    snr, ho_mask = plan["snr_db"], plan["handover"]
    shares = {}
    for (lo, hi), need in MARGINAL_OWN_SHARE.items():
        cs = np.nonzero((snr >= lo) & (snr <= hi) & ~ho_mask)[0]
        shares[f"{lo:g}-{hi:g} dB"] = got = float(
            np.mean([int(c) in own_cell for c in cs]))
        check(got >= need, f"slice_marginal: {got:.3f} of the carriers at "
              f"{lo:g}-{hi:g} dB on their own cell, under {need}")
    t0 = time.perf_counter()
    cvc = marginal_card_vs_cpu(*snap)
    cvc_s = time.perf_counter() - t0
    sb_air = WB_K * adv / fs
    cyc_air = adv / fs
    return dict(
        channels=N_CH, t50=T50, wb_k=WB_K, air_s=len(wide) / fs,
        snr_db=list(MARGINAL_SNR_DB), dropout=list(plan["dropout"]),
        handover_carriers=len(ho), superblocks=n_sb,
        cycles=len(head) - 1, parity_channels=N_CH - len(differ),
        superblock_parity_channels=N_CH - len(differ8),
        superblock_crc_scope=crc_scope,
        false_cell=len(false_cell), display_other_cell=len(display_other),
        bands=bands, own_cell_share=shares,
        crc_ok=int(sum(rx_f.crc_counts(c)[0] for c in range(N_CH))),
        crc_fail=int(sum(rx_f.crc_counts(c)[1] for c in range(N_CH))),
        relock_s=dict(sorted(relock.items())),
        relock_s_median=float(np.median(list(relock.values())))
        if relock else None,
        relock_s_max=max(relock.values()) if relock else None,
        fleet=dict(sb_wall_ms=float(np.mean(walls_f)) * 1e3,
                   sb_wall_min_ms=min(walls_f) * 1e3,
                   sb_wall_max_ms=max(walls_f) * 1e3,
                   rt_margin=sb_air / float(np.mean(walls_f))),
        fleet_one_cycle=dict(
            cycle_wall_ms=float(np.mean(walls_1[1:])) * 1e3,
            rt_margin=cyc_air / float(np.mean(walls_1[1:]))),
        per_channel=dict(cycle_wall_ms=float(np.mean(walls_p[1:])) * 1e3,
                         cycle_wall_min_ms=min(walls_p[1:]) * 1e3,
                         cycle_wall_max_ms=max(walls_p[1:]) * 1e3,
                         rt_margin=cyc_air / float(np.mean(walls_p[1:]))),
        card_vs_cpu=cvc, launches=launches,
        stage_s=dict(fixture=fixture_s,
                     fleet=float(np.sum(walls_f)),
                     per_channel=float(np.sum(walls_p)),
                     fleet_one_cycle=float(np.sum(walls_1)), parity=parity_s,
                     card_vs_cpu=cvc_s),
        phase_s=time.perf_counter() - t_phase)


def front_rows(air, n_ch: int) -> tuple[list[dict], list, dict]:
    """K3 and K4 against their plain versions at n_ch channels (t50 =
    T50) over the first two streamed windows of the device air `air`,
    within TOL_FRONT_REL of the plain output's RMS; event times (9 runs
    of 20 launches) and the plain versions' times.  Returns the rows, the
    profiler jobs and the second window's inputs and outputs (K4's rows z,
    K4's and the plain output yk and yp, the resampler history after it
    (K3's tails), t36 and K3's arguments a3), for further checks."""
    hop = n_ch // 2
    adv = T50 * hop
    t36 = T50 * 18 // 25
    need = T50 + 2 * CH.TAPS_PER_BRANCH - 1
    h0 = torch.zeros((CH.RS_TAPS_PER_PHASE - 1, n_ch), dtype=torch.float32,
                     device=air.device)
    hk = hp = (h0, h0)
    for b in range(2):
        win = air[b * adv:b * adv + need * hop]
        z = [part.contiguous().reshape(need, hop)
             for part in (win.real, win.imag)]
        hprev = hk
        rk = CK.fold_dft_resample(z[0], z[1], *hk, n_ch, t36)
        rp = CK.fold_dft_resample_plain(z[0], z[1], *hp, n_ch, t36)
        hk, hp = rk[2:], rp[2:]
    torch.cuda.synchronize()
    rms = float(torch.sqrt((rp[0] ** 2 + rp[1] ** 2).mean()))
    err3 = max(maxerr(rk[0], rp[0]), maxerr(rk[1], rp[1]))
    check(err3 <= TOL_FRONT_REL * rms, f"K3 at n_ch={n_ch}: error {err3} vs "
          f"rms {rms}")
    yk = CK.fold_dft(z[0], z[1], n_ch)
    yp, err4, rms4 = k4_check(z[0], z[1], n_ch, yk)
    a3 = (z[0], z[1], hprev[0], hprev[1], n_ch, t36)
    t3 = batch_ms(lambda: CK.fold_dft_resample(*a3), 20, 9)
    t4 = batch_ms(lambda: CK.fold_dft(z[0], z[1], n_ch), 20, 9)
    k3 = dict(name="K3 fold_dft_resample", channels=n_ch, max_abs_err=err3,
              rms=rms, ms=float(np.median(t3)), min_ms=min(t3),
              max_ms=max(t3),
              plain_ms=median_ms(
                  lambda: CK.fold_dft_resample_plain(*a3), 1, 3),
              **k3_work(need, n_ch, 2 * CH.TAPS_PER_BRANCH, t36))
    k4 = dict(name="K4 fold_dft", channels=n_ch, max_abs_err=err4,
              rms=rms4, ms=float(np.median(t4)), min_ms=min(t4),
              max_ms=max(t4),
              plain_ms=median_ms(
                  lambda: CK.fold_dft_plain(z[0], z[1], n_ch), 1, 3),
              **k4_work(need, n_ch, 2 * CH.TAPS_PER_BRANCH))
    jobs = [(k3, "device_ms", lambda: CK.fold_dft_resample(*a3)),
            (k4, "device_ms", lambda: CK.fold_dft(z[0], z[1], n_ch))]
    return [k3, k4], jobs, dict(z=z, yk=yk, yp=yp, history=hk, t36=t36,
                                a3=a3)


def wide_receiver(dev, n_ch: int, wb_k: int, n_timed: int,
                  n_host: int) -> tuple[dict, object, object]:
    """TetraReceiver(wideband=n_ch, t50=T50, fleet=True, wb_k=wb_k) over
    cell_air_device's air (N_CELLS cells, CFO +-400 Hz, 25 dB, built on
    the card): staged superblocks over WARM_SECONDS of warm-up, n_timed
    timed ones with the host-clock stages of slice_pipeline
    (PIPE_STAGES), then n_host superblocks fed as host cf32 through
    process_wideband (the ingest path), each timed ("rest": its framing
    and upload).  Gates after flush_wideband(): the fleet slice's three
    and quality_ok (fleet_gates), and K1-K4 launched wb_k times a
    superblock.  Returns the readings, the air (on the card) and a job
    that profiles the stream's next superblock for the busy share."""
    rx = TetraReceiver(wideband=n_ch, t50=T50, fleet=True, wb_k=wb_k,
                       device=dev)
    adv, wl = rx._wb["advance"], rx._wb["wide_len"]
    fs = n_ch * 25_000
    sb_adv = wb_k * adv
    warm = int(WARM_SECONDS * fs / sb_adv) + 1
    n_staged = warm + n_timed
    # and one more superblock for the profiler window
    need = (n_staged + n_host + 1) * sb_adv + wl
    t0 = time.perf_counter()
    air = cell_air_device(n_ch, need / fs + 0.05, N_CELLS, device=dev)
    torch.cuda.synchronize()
    fixture_s = time.perf_counter() - t0
    check(len(air) >= need, f"{len(air)} samples of air, {need} needed")
    staged = staged_windows(air, adv, wl, wb_k, dev, count=n_staged)
    wrappers = zero_launches()
    for sb in staged[:warm]:
        rx.process_wideband_staged(*sb)
    ok0 = sum(rx.crc_counts(c)[0] for c in range(n_ch))
    fail0 = sum(rx.crc_counts(c)[1] for c in range(n_ch))
    clock = StageClock()
    for owner, name, stage in PIPE_STAGES:
        clock.wrap(owner, name, stage)
    walls, host_walls, host_stage = [], [], {}
    try:
        for sb in staged[warm:]:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            rx.process_wideband_staged(*sb)
            walls.append(time.perf_counter() - ts)
        staged_stage = dict(clock.sec)
        lo = n_staged * sb_adv
        for k in range(n_host):
            # the first feed primes the buffer with a window's head
            hi = n_staged * sb_adv + (k + 1) * sb_adv + wl - adv
            chunk = air[lo:hi].cpu().numpy()
            lo = hi
            torch.cuda.synchronize()
            ts = time.perf_counter()
            rx.process_wideband(chunk)
            host_walls.append(time.perf_counter() - ts)
        host_stage = {k: v - staged_stage[k] for k, v in clock.sec.items()}
        host_stage["rest"] = (sum(host_walls) - host_stage["step enqueue"]
                              - host_stage["fleet engine call"])
    finally:
        clock.close()
    rx.flush_wideband()
    launches = read_launches(wrappers)
    n_sb = n_staged + n_host
    check(all(n == wb_k * n_sb for n in launches.values()),
          f"slice_wide {n_ch}: launches {launches} in {n_sb} superblocks")
    gates = fleet_gates(rx, ok0, fail0, f"slice_wide {n_ch}", quality=True)
    sb_air = sb_adv / fs
    ms = np.asarray(walls) * 1e3
    stage_ms = {k: v * 1e3 / len(walls) for k, v in staged_stage.items()}
    stage_ms["rest"] = (float(ms.mean()) - stage_ms["step enqueue"]
                        - stage_ms["fleet engine call"])
    res = dict(
        channels=n_ch, t50=T50, wb_k=wb_k, warm=warm, timed=len(walls),
        host_cf32=len(host_walls), air_s=len(air) / fs, fixture_s=fixture_s,
        sb_air_ms=sb_air * 1e3,
        sb_wall_ms=dict(mean=float(ms.mean()), min=float(ms.min()),
                        max=float(ms.max())),
        stage_ms_per_sb=stage_ms,
        rt_margin=sb_air / (ms.mean() / 1e3),
        wideband_msps=sb_adv / (ms.mean() / 1e3) / 1e6,
        latency_ms=sb_air * 1e3 + float(ms.mean()),
        fleet_threads=rx.fleet.threads,
        row_capacity=rx.fleet._cap,
        **gates, launches=launches)
    if host_walls:
        hw = float(np.mean(host_walls)) * 1e3
        res["host_cf32"] = dict(
            sb_wall_ms=hw, rt_margin=sb_air / (hw / 1e3),
            wideband_msps=sb_adv / (hw / 1e3) / 1e6,
            stage_ms_per_sb={k: v * 1e3 / len(host_walls)
                             for k, v in host_stage.items()})
    del staged
    nxt = staged_windows(air, adv, wl, wb_k, dev, first=n_staged + n_host,
                         count=1)[0]

    def profile_job():
        """Busy share (device kernel time over wall) over one superblock,
        the stream's next, in one torch.profiler window."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rx.process_wideband_staged(*nxt)
            rx.flush_wideband()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(_device_ms(e) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        res["profile"] = dict(superblocks=1, wall_ms=wall, device_ms=busy,
                              busy_share=busy / wall)

    return res, air, profile_job


def ptxas_report(kernels=("fold_fft_kernelILi8E", "fold_fft_kernelILi4E")
                 ) -> dict:
    """Registers, spill stores and loads (bytes) and shared memory of the
    named kernels, from the nvcc build's ptxas report (ops/_build writes
    it beside the library); {} where the build was not made here."""
    import re
    path = os.path.join(_build.BUILD_DIR, "ptxas.log")
    if not os.path.exists(path):
        return {}
    out, cur = {}, None
    for line in open(path):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = next((k for k in kernels if k in m.group(1)), None)
            continue
        if cur is None:
            continue
        info = out.setdefault(cur, {})
        for key, pat in (("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem_static", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                info[key] = int(m.group(1))
    return out


def wide_demod(dev) -> tuple[dict, list, list]:
    """The demod at bench.py's width (WIDE_DEMOD_C channels x T_DEMOD
    samples, heterogeneous_fleet_iq): demod_fast.demod_blocks over
    WIDE_DEMOD_K blocks of host IQ, and the lean chain
    (_demod_block_impl, tc_out, bench.py's form) over the same blocks on
    the card, each the median of WIDE_DEMOD_RUNS timed calls; then K1 and
    K2 against their plain versions from the chain's warm state after
    WARM_BLOCKS blocks, at each of WIDE_K12_C channels (demod_rows: K1
    within TOL_K1_MF_WIDE and TOL_K1_STATE_WIDE, K2 under k2_check's
    marginal-SNR rule)."""
    C = WIDE_DEMOD_C
    t0 = time.perf_counter()
    xr, xi = heterogeneous_fleet_iq(WARM_BLOCKS + 1, C, T_DEMOD)
    fixture_s = time.perf_counter() - t0
    k = WIDE_DEMOD_K
    iq = np.empty(xr[:k].shape, np.complex64)
    iq.real, iq.imag = xr[:k], xi[:k]
    n_chunks = DF.n_chunks_for(T_DEMOD)
    host = []
    for _ in range(WIDE_DEMOD_RUNS + 1):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        st, outs = DF.demod_blocks(DF.demod_init(C, dev), iq)
        outs["dibits"].sum().item()
        host.append(time.perf_counter() - ts)
    del iq, outs
    check(bool(st.agc_gain.isfinite().all()), "demod_blocks: state not "
          "finite")
    xr_d = torch.from_numpy(xr).to(dev)
    xi_d = torch.from_numpy(xi).to(dev)
    dev_t = []
    for _ in range(WIDE_DEMOD_RUNS + 1):
        st = DF.demod_init(C, dev)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        for j in range(k):
            st, o = DF._demod_block_impl(st, xr_d[j], xi_d[j], n_chunks,
                                         tc_out=True)
        o["dist_tc"].sum().item()
        dev_t.append(time.perf_counter() - ts)
    samples = k * C * T_DEMOD
    res = dict(channels=C, block=T_DEMOD, k=k, fixture_s=fixture_s,
               demod_blocks_msps=samples / float(np.median(host[1:])) / 1e6,
               demod_blocks_ms=[t * 1e3 for t in host[1:]],
               resident_msps=samples / float(np.median(dev_t[1:])) / 1e6,
               resident_ms=[t * 1e3 for t in dev_t[1:]])
    del xr_d, xi_d
    state = warm_demod(dev, xr, xi, WARM_BLOCKS)
    rows, jobs = [], []
    for c in WIDE_K12_C:
        st_c = type(state)(*(t[:c].contiguous() for t in state))
        x_r = torch.from_numpy(xr[WARM_BLOCKS, :c].T.copy()).to(dev)
        x_i = torch.from_numpy(xi[WARM_BLOCKS, :c].T.copy()).to(dev)
        r, j = demod_rows(st_c, x_r, x_i, TOL_K1_MF_WIDE, f"K2 at C={c}",
                          tol_state=TOL_K1_STATE_WIDE,
                          axis_eps=K2_AXIS_EPS)
        rows += r
        jobs += j
    return res, rows, jobs


def phase_slice_wide(dev) -> tuple[dict, list, list, list]:
    """The JAX round's wide configurations (WIDE_CONFIGS) through the
    port's fleet receiver on the card (wide_receiver), K3 and K4 at each
    one's n_ch on its air (front_rows), the demod at bench.py's width and
    K1/K2 at WIDE_K12_C channels (wide_demod), and the K4 FFT kernels'
    ptxas report.  Launches are counted over the receivers' runs alone.
    Returns the phase's results, the kernel rows at the new shapes, the
    profiler jobs of the rows and those of the receivers."""
    t_phase = time.perf_counter()
    res = dict(receivers={}, launches=dict.fromkeys(kernel_wrappers(), 0))
    rows, jobs, profiles = [], [], []
    for n_ch, wb_k, n_timed, n_host in WIDE_CONFIGS:
        t0 = time.perf_counter()
        r, air, prof = wide_receiver(dev, n_ch, wb_k, n_timed, n_host)
        for name, n in r["launches"].items():
            res["launches"][name] += n
        fr, fj, _ = front_rows(air, n_ch)
        del air
        r["phase_s"] = time.perf_counter() - t0
        res["receivers"][f"{n_ch}x{wb_k}"] = r
        rows += fr
        jobs += fj
        profiles.append(prof)
    t0 = time.perf_counter()
    res["demod"], dr, dj = wide_demod(dev)
    res["demod"]["phase_s"] = time.perf_counter() - t0
    res["ptxas"] = ptxas_report()
    res["phase_s"] = time.perf_counter() - t_phase
    return res, dr + rows, dj + jobs, profiles


def kernel_line(rows: list, launches_wide: dict, extra=None) -> dict:
    """The contract's JSON object of per-kernel results."""
    extra = extra or (lambda r: {})
    return {"kernels": [dict(
        name=r["name"], route="cuda", source=SOURCES[r["name"]],
        replaces=REPLACES[r["name"]], **extra(r),
        launches_wide=launches_wide[r["name"]],
        max_abs_err=r["max_abs_err"], ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r.get("library_ms"),
        **{k: r[k] for k in ("channels", "device_ms", "full_ms",
                             "full_device_ms", "full_bound_ms",
                             "resample_ms", "resample_device_ms",
                             "resample_bound_ms") if k in r})
        for r in rows]}


def main_slice_wide(dev, gpu: str) -> None:
    """chip_smoke.py slice_wide: the build, then phase slice_wide alone,
    its kernel rows and profiler windows."""
    t0 = time.perf_counter()
    wide, rows, jobs, profiles = phase_slice_wide(dev)
    phase_device_times(jobs)
    for prof in profiles:
        prof()
    print(f"slice_wide: gpu=[{gpu}] " + json.dumps(wide), flush=True)
    print(f"timing: gpu=[{gpu}] " + json.dumps(dict(
        slice_wide=time.perf_counter() - t0)), flush=True)
    for r in rows:
        print("kernel_wide: " + json.dumps(r), flush=True)
    print(gpu)
    print(json.dumps({"kernels_wide": kernel_line(
        rows, wide["launches"])["kernels"]}))
    # not the contract's last line: only the whole script prints that
    print(json.dumps({"phase": "slice_wide", "passed": True}))


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    only = sys.argv[1:]
    if only not in ([], ["slice_wide"]):
        raise SystemExit(f"usage: chip_smoke.py [slice_wide], not {only}")
    exact_float32()
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    t_start = time.perf_counter()
    laps, last = {}, [t_start]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = now - last[0]
        last[0] = now

    _build.load()
    lap("build")
    print(f"header: gpu=[{gpu}] torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvcc=[{nvcc_version()}] "
          f"kernel_build_s={_build.build_seconds:.1f}", flush=True)
    if only:
        main_slice_wide(dev, gpu)
        return
    t0 = time.perf_counter()
    wide = cell_air(N_CH, AIR_SECONDS, N_CELLS)
    print(f"fixture: {len(wide)} wideband samples "
          f"({len(wide) / (N_CH * 25_000):.2f} s of air) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    lap("fixture")
    demod, jobs = phase_demod_kernels(dev)
    front, front_jobs = phase_front_kernels(dev, wide)
    lap("kernels")
    rows = demod + front
    staged = staged_windows(wide, T50 * N_CH // 2, (T50 - 1) * N_CH // 2
                            + N_CH * CH.TAPS_PER_BRANCH, WB_K, dev)
    sl, soft_in = phase_slice(dev, staged)
    print(f"slice: gpu=[{gpu}] " + json.dumps(sl), flush=True)
    lap("slice")
    fec_rows = fec_trellis_rows(soft_in)
    del soft_in
    lap("fec_trellis")
    t0 = time.perf_counter()
    pipe, pipe_profile = phase_slice_pipeline(dev, staged)
    pipe["phase_s"] = time.perf_counter() - t0
    del staged[:-PIPE_PROFILED]
    lap("slice_pipeline")
    nf_rx = []
    nf = phase_slice_nonfleet(dev, wide, attach=nf_rx.append)
    print(f"slice_nonfleet: gpu=[{gpu}] " + json.dumps(nf), flush=True)
    lap("slice_nonfleet")
    t0 = time.perf_counter()
    pool = phase_slice_pool(dev, wide, nf_rx.pop())
    pool["phase_s"] = time.perf_counter() - t0
    print(f"slice_pool: gpu=[{gpu}] " + json.dumps(pool), flush=True)
    lap("slice_pool")
    t0 = time.perf_counter()
    mesh = phase_slice_mesh(dev, wide)
    mesh["phase_s"] = time.perf_counter() - t0
    print(f"slice_mesh: gpu=[{gpu}] " + json.dumps(mesh), flush=True)
    lap("slice_mesh")
    marginal = phase_slice_marginal(dev)
    print(f"slice_marginal: gpu=[{gpu}] " + json.dumps(marginal), flush=True)
    lap("slice_marginal")
    voice_launches = (SK.trellis.launches, AK.synth.launches)
    wide_res, wide_rows, wide_jobs, wide_profiles = phase_slice_wide(dev)
    voice_launches_wide = {
        "speech_trellis": SK.trellis.launches - voice_launches[0],
        "acelp_synth": AK.synth.launches - voice_launches[1]}
    lap("slice_wide")
    voice = phase_slice_voice(dev, nf)
    lap("slice_voice")
    voice_fleet, speech_row = phase_slice_voice_fleet(dev)
    print(f"slice_voice_fleet: gpu=[{gpu}] " + json.dumps(voice_fleet),
          flush=True)
    acelp_row = acelp_synth_row(dev)
    lap("slice_voice_fleet")
    modes, warm = phase_slice_modes(dev, wide)
    lap("slice_modes")
    del wide
    phase_device_times(jobs + front_jobs + wide_jobs)
    pipe_profile()
    for prof in wide_profiles:
        prof()
    print(f"slice_wide: gpu=[{gpu}] " + json.dumps(wide_res), flush=True)
    print(f"slice_pipeline: gpu=[{gpu}] " + json.dumps(pipe), flush=True)
    voice["decode_slot_profile"] = decode_slot_device_ops(dev)
    print(f"slice_voice: gpu=[{gpu}] " + json.dumps(voice), flush=True)
    modes["exact"]["block_profile"] = exact_device_ops(*warm["exact"])
    print(f"slice_modes: gpu=[{gpu}] " + json.dumps(modes), flush=True)
    lap("profiler windows")
    print(f"timing: gpu=[{gpu}] " + json.dumps(dict(
        laps, total=time.perf_counter() - t_start)), flush=True)
    for r in rows:
        print("kernel: " + json.dumps(r), flush=True)
    print("kernel: " + json.dumps(speech_row), flush=True)
    print("kernel: " + json.dumps(acelp_row), flush=True)
    for r in fec_rows:
        print("kernel: " + json.dumps(r), flush=True)
    for r in wide_rows:
        print("kernel_wide: " + json.dumps(r), flush=True)
    line = kernel_line(rows, wide_res["launches"], lambda r: dict(
        launches=sl["launches"][r["name"]],
        launches_per_superblock=sl["launches"][r["name"]]
        / sl["superblocks_driven"],
        launches_nonfleet=nf["launches"][r["name"]],
        launches_per_cycle_nonfleet=nf["launches_per_cycle"][r["name"]],
        launches_modes=modes["launches"][r["name"]],
        launches_pool=pool["launches"][r["name"]],
        launches_pipeline=pipe["pcie"]["launches"][r["name"]],
        launches_mesh=mesh["launches"][
            "resample (K3's second kernel)"
            if r["name"] == "K3 fold_dft_resample" else r["name"]],
        launches_marginal=marginal["launches"][r["name"]]))
    for k in line["kernels"]:
        k["wide"] = [dict(channels=r["channels"], ms=r["ms"],
                          device_ms=r.get("device_ms"),
                          bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                          max_abs_err=r["max_abs_err"])
                     for r in wide_rows if r["name"] == k["name"]]
    n_sb = voice_fleet["superblocks"]
    line["kernels"] += kernel_line(
        [speech_row], voice_launches_wide, lambda r: dict(
            launches=voice_fleet["trellis_launches"],
            launches_per_superblock=voice_fleet["trellis_launches"] / n_sb,
            rows=r["rows"], steps=r["steps"]))["kernels"]
    line["kernels"] += kernel_line(
        [acelp_row], voice_launches_wide, lambda r: dict(
            launches=voice_fleet["acelp_launches"],
            launches_per_superblock=voice_fleet["acelp_launches"] / n_sb,
            calls=r["calls"], items=r["items"],
            call_ms=r["call_ms"]))["kernels"]
    # launches_wide: not counted (slice_wide's receivers launch it too)
    line["kernels"] += kernel_line(
        fec_rows, {"fec_trellis": None}, lambda r: dict(
            launches=sl["trellis_launches"],
            launches_per_superblock=sl["trellis_launches"]
            / sl["superblocks"], rows=r["rows"], steps=r["steps"]))[
                "kernels"]
    print(gpu)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)

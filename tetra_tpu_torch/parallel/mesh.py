"""Channel data-parallelism over torch.distributed (port of
tetra_tpu/parallel/mesh.py).

The scale-out axes:
  * "ch" (data parallel): independent 25 kHz channels.  The demod chain is
    embarrassingly parallel across channels, so each rank runs the whole
    chain on its own contiguous block of channels with no communication.
  * "t" (sequence parallel): within-channel time sharding for the stateless
    convolution stages, overlap-save with the (M-1)-sample halo sent from
    rank i to rank i+1 (the reference's lax.ppermute).
  * ("host", "chip"): each host ingests its own wideband feed, and its
    channels shard over its chips.  Hosts exchange only the all-reduced
    health scalar.

The reference's shard_map programs take global arrays; torch runs one
process per device (multi-controller), so each function here is called by
every rank on its own shard: its block of channels (host-major, global
channel = h*n_ch + chip*ch_per_chip + j, with channels splitting evenly),
its time shard, or its rows.  Where the reference returns a global array,
a rank returns its local columns and their offset; gather_host_columns
all-gathers a host's columns over its "chip" group, which is what
FleetEngine.process_packed2 or the host decode consumes.

Meshes span the initialised world (init_distributed).  The backend is the
caller's choice: "nccl" when every rank has a card of its own, "gloo" when
ranks share a card or run on the CPU.  Under gloo only all_reduce takes
CUDA tensors here, so the halos and the gathered words travel as host
copies while the compute stays on the ranks' devices.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import resolve_device
from ..core.fir import fir_valid
from ..ops import chan_kernel as CK
from ..rx import demod_fast as demod_mod
from . import channelizer as CH


def check_backend(backend: str, devices: list) -> None:
    """Raise if `backend` cannot serve ranks on `devices` (the devices of
    the ranks one host starts): NCCL needs a card per rank and refuses two
    ranks on one GPU in one communicator."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: 'nccl' or 'gloo'")
    if backend != "nccl":
        return
    devs = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devs):
        raise ValueError("backend='nccl' needs a CUDA device for every rank; "
                         "use 'gloo' on the CPU")
    idx = [d.index for d in devs]
    if len(set(idx)) != len(idx) or max(idx) >= torch.cuda.device_count():
        raise ValueError(
            f"backend='nccl' with ranks on {idx} of "
            f"{torch.cuda.device_count()} card(s): NCCL refuses two ranks "
            f"on one GPU in one communicator; use 'gloo' to rehearse "
            f"several ranks on one card")


def init_distributed(backend: str, init_method: str, world_size: int,
                     rank: int, device) -> torch.device:
    """Join the process group (`init_method` "tcp://host:port" or
    "file://path") and make `device` this rank's current device.  Returns
    the resolved device."""
    check_backend(backend, [device])
    device = resolve_device(device)
    if device.type == "cuda":
        # an initialised current device: DeviceMesh then keeps it rather
        # than pick rank % card count
        torch.cuda.set_device(device)
        torch.cuda.init()
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return device


def _mesh(shape: tuple, names: tuple, device) -> DeviceMesh:
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{int(np.prod(shape))} ranks; the world has {world}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, axis: str = "ch",
              device=None) -> DeviceMesh:
    """One-dimensional mesh over the whole world (n_devices, if given, must
    be its size); device: this rank's device (the current CUDA device
    unless the caller asks for the CPU)."""
    return _mesh((n_devices or dist.get_world_size(),), (axis,), device)


def make_mesh_2d(n_hosts: int, n_chips: int, device=None) -> DeviceMesh:
    """(host, chip) mesh: rank = host * n_chips + chip.  The host axis maps
    to separately fed workers, the chip axis to each host's cards."""
    return _mesh((n_hosts, n_chips), ("host", "chip"), device)


def _staged(group) -> bool:
    """Whether the group's collectives other than all_reduce need host
    tensors (gloo)."""
    return dist.get_backend(group) == "gloo"


def _split(n: int, mesh: DeviceMesh, axis: str) -> tuple[int, int]:
    """(offset, count) of this rank's contiguous block of n along axis."""
    k = mesh.size(mesh.mesh_dim_names.index(axis))
    if n % k:
        raise ValueError(f"{n} does not split evenly over {k} ranks of "
                         f"'{axis}'")
    return mesh.get_local_rank(axis) * (n // k), n // k


def host_channels(mesh: DeviceMesh, n_ch: int) -> tuple[int, int, int]:
    """(host, first global channel, count) of this rank on a (host, chip)
    mesh with n_ch channels per host."""
    h = mesh.get_local_rank("host")
    j0, count = _split(n_ch, mesh, "chip")
    return h, h * n_ch + j0, count


# ---------------------------------------------------------------------------
# Channel-sharded demod (dp axis)
# ---------------------------------------------------------------------------


def sharded_demod_init(mesh: DeviceMesh, channels: int, device=None
                       ) -> demod_mod.FastDemodState:
    """This rank's shard of demod_init(channels): its block of channels on
    the "ch" mesh, on `device` (the current CUDA device unless the caller
    asks for the CPU)."""
    return demod_mod.demod_init(_split(channels, mesh, "ch")[1], device)


def sharded_demod_step(mesh: DeviceMesh, block_len: int):
    """A rank's demod step: (state, xr, xi (C_local, T)) -> (state, outs,
    c0), outs the chain's outputs (sym_re, sym_im, dibits, valid, dist,
    fll_freq, agc_gain) for the rank's channels c0 .. c0 + C_local - 1.
    No communication: K1 and K2 run on the rank's own channels."""
    n_chunks = demod_mod.n_chunks_for(block_len)

    def step(state, xr, xi):
        state, outs = demod_mod._demod_block_impl(state, xr, xi, n_chunks)
        return state, outs, mesh.get_local_rank("ch") * xr.shape[0]

    return step


# ---------------------------------------------------------------------------
# Time-sharded overlap-save FIR with a halo exchange (sp axis)
# ---------------------------------------------------------------------------


def halo_fir(mesh: DeviceMesh, h: np.ndarray, axis: str = "t"):
    """A time-sharded streaming FIR: each rank holds a contiguous time shard
    of every channel, and sends its trailing M-1 samples to the next rank
    of `axis`; rank 0 takes zeros (zero history at t = 0).

    Returns fn: x (C, T_local) float32, T_local >= M - 1 -> y (C, T_local),
    this rank's shard of the unsharded causal convolution."""
    M = len(h)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    taps = torch.from_numpy(np.asarray(h, np.float32))

    def fir(x):
        i = mesh.get_local_rank(axis)
        staged = _staged(group)
        halo = x[:, -(M - 1):].contiguous()
        left = torch.zeros_like(halo)
        send = halo.cpu() if staged else halo
        recv = left.cpu() if staged else left
        req = None
        if i + 1 < n:
            req = dist.isend(send, dist.get_global_rank(group, i + 1),
                             group=group)
        if i > 0:
            dist.recv(recv, dist.get_global_rank(group, i - 1), group=group)
            left = recv.to(x.device)
        if req is not None:
            req.wait()
        return fir_valid(torch.cat([left, x], dim=1), taps)

    return fir


# ---------------------------------------------------------------------------
# Multi-host: 2-D (host, chip) mesh -- per-host wideband ingestion
# ---------------------------------------------------------------------------


def _wideband_geometry(n_ch: int, t50_new: int) -> tuple[int, int, int, int]:
    """(t36, wide_len, advance, n_chunks) of a t50_new-sample step."""
    if t50_new % 25:
        raise ValueError(f"t50_new={t50_new} is not a multiple of 25")
    t36 = t50_new * 18 // 25
    if t36 % demod_mod.K_SAMP:
        raise ValueError(f"t50_new {t50_new} gives t36={t36}, not a multiple "
                         f"of the demod chunk K_SAMP={demod_mod.K_SAMP}")
    hop = n_ch // 2
    wide_len = (t50_new - 1) * hop + n_ch * CH.TAPS_PER_BRANCH
    return t36, wide_len, t50_new * hop, demod_mod.n_chunks_for(t36)


def _front_end(wr, wi, hr, hi, n_ch: int, j0: int, count: int, t36: int):
    """K4 over the host's whole band (every chip computes it), this rank's
    columns j0 .. j0 + count - 1 sliced out, then the resample kernel alone
    on them with the rank's own (23, count) history, which the kernel
    writes for the next block."""
    yr, yi = CH._channelize_block_impl(wr, wi, n_ch, frame_major=True)
    yr = yr[:, j0:j0 + count].contiguous()
    yi = yi[:, j0:j0 + count].contiguous()
    return CK.resample(yr, yi, hr, hi, t36)


def sharded_wideband_demod_step(mesh: DeviceMesh, n_ch: int,
                                t50_new: int = 6400):
    """Multi-host front end: each host ingests its own n_ch x 25 kHz
    wideband feed, every chip of the host channelizes it (K4), slices its
    own channels before resampling them (no all-to-all), and runs the
    chunked demod (K1, K2 in its full form) on them.  The resampler carries
    each channel's history in the step state, so blocks continue the
    sample stream exactly.

    Returns (step, wide_len, advance).  step(state, wr, wi) with wr/wi the
    host's (wide_len,) float32 window on the rank's device (consecutive
    windows advance the raw stream by `advance`) -> (state, outs, c0): the
    rank's outputs for global channels c0 .. c0 + n_ch/chips - 1, and
    outs["fleet_dist"], the all-reduced mean symbol distance over every
    rank's valid symbols (the cross-host health in one collective)."""
    t36, wide_len, advance, n_chunks = _wideband_geometry(n_ch, t50_new)

    def step(state, wr, wi):
        _, c0, count = host_channels(mesh, n_ch)
        j0 = c0 % n_ch
        dstate, hr, hi = state
        rr, ri, hr, hi = _front_end(wr, wi, hr, hi, n_ch, j0, count, t36)
        dstate, outs = demod_mod._demod_block_impl(dstate, rr.T, ri.T,
                                                   n_chunks)
        valid = outs["valid"]
        tot = torch.stack([torch.where(valid, outs["dist"], 0.0).sum(),
                           valid.sum().to(torch.float32)])
        dist.all_reduce(tot)
        outs = dict(outs, fleet_dist=tot[0] / torch.clamp(tot[1], min=1.0))
        return (dstate, hr, hi), outs, c0

    return step, wide_len, advance


def sharded_wideband_superblock_step(mesh: DeviceMesh, n_ch: int,
                                     t50_new: int = 6400, kw: int = 2):
    """The fleet path's K-cycle superblock (rx/receiver._wideband_step_scan)
    on the (host, chip) mesh: per cycle channelize (K4, whole band) ->
    slice -> resample -> chunked demod (K1, K2 lean) -> pack_cycle_tc.

    Returns (step, wide_len, advance).  step(state, wrk, wik) with wrk/wik
    the host's (kw, wide_len) float32 windows -> (state, packed, health,
    c0): packed (kw*G + 2, n_ch/chips) int32 holds the rank's columns of
    global channels c0 .., G = n_chunks*2 + ceil(n_chunks/4) rows a cycle
    (pack_cycle_tc's symbol and count words), rows [-2]/[-1] the float32
    bits of the per-channel valid count and dist sum, as the single-card
    superblock; health (2,) is the all-reduced (valid count, dist sum).
    gather_host_columns gives the host's (kw*G + 2, n_ch) array that
    FleetEngine.process_packed2 consumes (rows [:-2])."""
    from ..rx.receiver import pack_cycle_tc

    t36, wide_len, advance, n_chunks = _wideband_geometry(n_ch, t50_new)

    def step(state, wrk, wik):
        _, c0, count = host_channels(mesh, n_ch)
        j0 = c0 % n_ch
        dstate, hr, hi = state
        vacc = torch.zeros(count, dtype=torch.float32, device=wrk.device)
        dacc = vacc
        packed_k = []
        for j in range(kw):
            rr, ri, hr, hi = _front_end(wrk[j], wik[j], hr, hi, n_ch, j0,
                                        count, t36)
            dstate, outs = demod_mod._demod_block_impl(
                dstate, rr.T, ri.T, n_chunks, tc_out=True)
            packed, vinc, dinc = pack_cycle_tc(
                outs["dibits_tc"], outs["valid_tc"], outs["dist_tc"], count,
                n_chunks)
            packed_k.append(packed)
            vacc = vacc + vinc
            dacc = dacc + dinc
        out = torch.cat(packed_k + [vacc.view(torch.int32)[None],
                                    dacc.view(torch.int32)[None]], dim=0)
        health = torch.stack([vacc.sum(), dacc.sum()])
        dist.all_reduce(health)
        return (dstate, hr, hi), out, health, c0

    return step, wide_len, advance


def gather_host_columns(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """All-gather a rank's local columns (..., n_ch/chips) over its host's
    "chip" group into the host's (..., n_ch), in chip order, on x's
    device."""
    group = mesh.get_group("chip")
    n = group.size()
    if n == 1:
        return x
    src = x.contiguous()
    if _staged(group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=-1).to(x.device)


def sharded_fec_decode(mesh: DeviceMesh, axis: str = "ch"):
    """Row-sharded mixed FEC: each rank runs the packed mixed decode
    (rx/fec._decode_mixed_packed) on its own type-5 rows; FEC rows are
    independent, so the one collective is the all-reduced CRC-ok count.
    Returns fn (t5p (N_local, 54) uint8, ks_table (16, 432) on every rank,
    scramb_idx (N_local,), tsel (N_local,)) -> (out (N_local, 35) uint8,
    ok_total: int64 scalar tensor over every rank's rows)."""
    from ..rx import fec as rx_fec

    group = mesh.get_group(axis)

    def decode(t5p, ks_table, scramb_idx, tsel):
        out = rx_fec._decode_mixed_packed(t5p, ks_table, scramb_idx, tsel)
        ok_total = out[:, -1].to(torch.int64).sum()
        dist.all_reduce(ok_total, group=group)
        return out, ok_total

    return decode


def sharded_wideband_demod_init(mesh: DeviceMesh, n_ch: int, device=None):
    """This rank's (demod state, resampler history re, im) for its block of
    the n_hosts*n_ch host-major channels: the history is (23, n_ch/chips),
    frame-major as the port's single-card receiver keeps it (the
    reference's is (C, 23); convert.mesh_shard_from_numpy converts)."""
    _, _, count = host_channels(mesh, n_ch)
    device = resolve_device(device)
    pad = CH.RS_TAPS_PER_PHASE - 1
    hist = lambda: torch.zeros((pad, count), dtype=torch.float32,
                               device=device)
    return demod_mod.demod_init(count, device), hist(), hist()

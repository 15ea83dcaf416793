"""One rank of the port's mesh tests (tests/test_torch_mesh.py), run as

    python tests/torch_mesh_ranks.py JOB RANK WORLD DIR

on the CPU under gloo, with a file:// rendezvous in DIR.  It reads the
seeded inputs from DIR/inputs.npz, runs JOB's cases on its shard and
writes its outputs to DIR/JOB_rank<RANK>.npz.  It imports nothing of jax
or tetra_tpu: the test compares the outputs with the JAX package's.

Jobs: "four" (4 ranks: halo_fir on a 4-rank "t" mesh, sharded_fec_decode
on a 4-rank "ch" mesh, the wideband demod step and the superblock step on
a 2x2 (host, chip) mesh), "two" (sharded_demod_step on 2 ranks), "one"
(the superblock step on a 1x1 mesh from the JAX init state, converted).
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from tetra_tpu_torch import convert
from tetra_tpu_torch.parallel import mesh as M

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _windows(wide: np.ndarray, base: int, advance: int, wide_len: int,
             k: int = 1):
    """k windows of one host's stream from `base`, as (k, wide_len) float32
    re, im."""
    w = np.stack([wide[base + j * advance:base + j * advance + wide_len]
                  for j in range(k)])
    return _t(w.real.astype(np.float32)), _t(w.imag.astype(np.float32))


def _superblocks(mesh, z, out: dict, state, key: str) -> None:
    """The superblock step (t50 = 1600, kw = 2) over z's host streams; the
    host's gathered columns per superblock into out[key] on chip 0."""
    h = mesh.get_local_rank("host")
    n_ch, kw = int(z["sb_n_ch"]), 2
    step, wide_len, advance = M.sharded_wideband_superblock_step(
        mesh, n_ch, t50_new=1600, kw=kw)
    packed, health = [], []
    for s in range(int(z["sb_n_super"])):
        wr, wi = _windows(z["sb_wide"][h], s * kw * advance, advance,
                          wide_len, kw)
        state, out_l, hl, c0 = step(state, wr, wi)
        packed.append(M.gather_host_columns(mesh, out_l).numpy())
        health.append(hl.numpy())
    if mesh.get_local_rank("chip") == 0:
        out[key] = np.stack(packed)
        out[key + "_health"] = np.stack(health)
    return state


def job_four(z, rank: int) -> dict:
    out = {}
    # halo_fir: 4 time shards of every channel
    mesh_t = M.make_mesh(4, "t", CPU)
    x = z["halo_x"]
    T = x.shape[1] // 4
    out["halo_y"] = M.halo_fir(mesh_t, z["halo_h"])(
        _t(x[:, rank * T:(rank + 1) * T])).numpy()
    # sharded_fec_decode: 4 row shards
    mesh_ch = M.make_mesh(4, "ch", CPU)
    n = z["fec_t5p"].shape[0] // 4
    rows = slice(rank * n, (rank + 1) * n)
    fec, ok = M.sharded_fec_decode(mesh_ch)(
        _t(z["fec_t5p"][rows]), _t(z["fec_ks"]), _t(z["fec_idx"][rows]),
        _t(z["fec_tsel"][rows]))
    out["fec_out"], out["fec_ok"] = fec.numpy(), int(ok)
    # the wideband demod step on the 2x2 (host, chip) mesh
    mesh = M.make_mesh_2d(2, 2, CPU)
    n_ch = int(z["wb_n_ch"])
    h, c0, count = M.host_channels(mesh, n_ch)
    step, wide_len, advance = M.sharded_wideband_demod_step(mesh, n_ch)
    state = M.sharded_wideband_demod_init(mesh, n_ch, CPU)
    keys = ("dibits", "valid", "dist", "fleet_dist")
    res = {k: [] for k in keys}
    for s in range(int(z["wb_steps"])):
        wr, wi = _windows(z["wb_wide"][h], s * advance, advance, wide_len)
        state, outs, c = step(state, wr[0], wi[0])
        assert c == c0
        for k in keys:
            res[k].append(outs[k].numpy())
    out.update({"wb_" + k: np.stack(v) for k, v in res.items()})
    out["wb_c0"] = c0
    # the superblock step on the same mesh
    _superblocks(mesh, z, out, M.sharded_wideband_demod_init(
        mesh, int(z["sb_n_ch"]), CPU), "sb2x2")
    return out


def job_two(z, rank: int) -> dict:
    mesh = M.make_mesh(2, "ch", CPU)
    C = z["demod_xr"].shape[0]
    state = M.sharded_demod_init(mesh, C, CPU)
    rows = slice(rank * C // 2, (rank + 1) * C // 2)
    step = M.sharded_demod_step(mesh, z["demod_xr"].shape[1])
    _, outs, c0 = step(state, _t(z["demod_xr"][rows]),
                       _t(z["demod_xi"][rows]))
    res = {k: outs[k].numpy() for k in ("dibits", "valid", "sym_re",
                                        "sym_im")}
    res["c0"] = c0
    return res


def job_one(z, rank: int) -> dict:
    """The 1x1 superblock from the reference's init state (host 0's
    stream), converted; and its state after the run, converted back."""
    mesh = M.make_mesh_2d(1, 1, CPU)
    fields = {k[len("conv_"):]: z[k] for k in z.files
              if k.startswith("conv_") and k not in ("conv_hr", "conv_hi")}
    state = convert.mesh_shard_from_numpy(fields, z["conv_hr"], z["conv_hi"],
                                          0, int(z["sb_n_ch"]), CPU)
    out = {}
    dstate, hr, hi = _superblocks(mesh, z, out, state, "sb1x1")
    fields, hr, hi = convert.mesh_shard_to_numpy(dstate, hr, hi)
    out.update({"end_" + k: v for k, v in fields.items()})
    out["end_hr"], out["end_hi"] = hr, hi
    return out


def main(job: str, rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    M.init_distributed("gloo", "file://" + os.path.join(tmp, job + ".rdv"),
                       world, rank, CPU)
    try:
        z = np.load(os.path.join(tmp, "inputs.npz"))
        out = {"four": job_four, "two": job_two, "one": job_one}[job](
            z, rank)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(tmp, f"{job}_rank{rank}.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

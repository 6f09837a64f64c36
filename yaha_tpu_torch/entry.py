"""Driver entry points of the port: a one-card step and the composed
multi-device dryrun.

Counterpart of __graft_entry__.py:

  entry(device)        (step, example_args): the flagship DP, the banded
                       X-drop extension at -BW 5, on the card
                       (ops/sw_cuda.extension_forward: ext_reg_kernel<21>
                       of csrc/ext_kernels.cu)
  dryrun_multichip(n_devices, device)
                       the staged engine with the device seeder over a
                       (data x model) grid (parallel/mesh.py): the index
                       sharded by hash range over `model`, the reads over
                       `data`, the shards' hits merged on the card, then
                       the DP kernels, the gather and the walk; the output
                       must equal the single-device engine's byte for byte

Every entry runs on the card unless the caller passes device="cpu", which
runs the kernels' plain PyTorch versions; "cuda" without a card raises.
On one card the grid's entries repeat the device (parallel/mesh.make_mesh
allows it), as the reference runs its meshes on virtual CPU devices.

  python -m yaha_tpu_torch.entry [--device cuda|cpu]
      entry(), then dryrun_multichip(8) in a child process (the
      reference's __main__).  YT_DRYRUN_MBP sizes the dryrun's genome
      (default 100 Mbp), YT_DRYRUN_L15=0 skips its L15 arm.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time

import numpy as np


def _example_problems(n, ql, seed=0):
    """The reference's example extension problems (__graft_entry__.py:12):
    the same bytes from the same seed."""
    rng = np.random.default_rng(seed)
    bw2 = 10
    q = rng.integers(0, 4, (n, ql)).astype(np.uint8)
    qlens = rng.integers(ql // 2, ql + 1, n).astype(np.int32)
    rl = ql + 2 * bw2
    r = np.zeros((n, rl), np.uint8)
    for k in range(n):
        L = qlens[k]
        r[k, :L] = q[k, :L]
        m = rng.random(L) < 0.1
        r[k, :L][m] = rng.integers(0, 4, int(m.sum()))
        r[k, L:] = rng.integers(0, 4, rl - L)
    rlens = (qlens + bw2).astype(np.int32)
    return q, qlens, r, rlens


# The reference step's scoring (__graft_entry__.py:34-36).
ENTRY_KW = dict(band_width=5, go=5, ge=2, rc=3, ms=1, max_gap=50,
                max_intron=50, x_cutoff=25)


def _torch_device(device):
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %s requested but no CUDA device is "
                           "available (torch %s); pass device=\"cpu\" for "
                           "the plain versions" % (dev, torch.__version__))
    return dev


def entry(device="cuda"):
    """(step, example_args) for a one-card forward step.

    step(q, qlens, r, rlens) runs ops/sw_cuda.extension_forward at -BW 5
    on `device` (the register kernel ext_reg_kernel<21> on a card, its
    plain version on "cpu") and returns (score, maxi, maxj) int32 tensors.
    The reference's entry runs sw_batch.batched_extension_forward, the XLA
    twin; its score, maxi and maxj are the contract this step meets
    (tests/test_torch_entry.py holds them equal)."""
    import torch
    from .ops import sw_cuda
    dev = _torch_device(device)

    def step(q, qlens, r, rlens):
        args = [torch.as_tensor(np.ascontiguousarray(a)).to(dev)
                for a in (q, qlens, r, rlens)]
        out = sw_cuda.extension_forward(*args, **ENTRY_KW)
        return out["score"], out["maxi"], out["maxj"]

    return step, _example_problems(64, 64)


# ---- the composed dryrun ----

def _aa_for(index, word_len):
    from .config import AlignmentArgs
    aa = AlignmentArgs()
    aa.word_len = word_len
    aa.qfile_name = "dryrun.fa"
    aa.xfile_name = "dryrun.X"
    aa.ofile_name = "out.sam"
    aa.post_process(True)
    aa.max_hits = min(aa.max_hits, index.max_hits)
    aa.fastq = False
    return aa


def _write_genome(fa, tmp, stem, word_len, threads=4):
    """FASTA bytes -> <tmp>/<stem>.nib2 and its index (the port's native
    compress and index build); returns (nib2 path, index path, SO bytes,
    ROA bytes)."""
    from .io import index_io, nib2
    from .native import host as nhost
    fa_path = os.path.join(tmp, stem + ".fasta")
    gpath = os.path.join(tmp, stem + ".nib2")
    xpath = os.path.join(tmp, "%s.X%02d_01_65525S" % (stem, word_len))
    with open(fa_path, "wb") as f:
        f.write(fa)
    nhost.compress_fasta_file(fa_path, gpath)
    os.unlink(fa_path)
    with open(gpath, "rb") as f:
        g = nib2.load(f.read())
    so, roa, tm = nhost.build_index(g, word_len, 1, 65525,
                                    n_threads=threads)
    del g
    index_io.write_index(xpath, word_len, 65525, so, roa, tm)
    return gpath, xpath, int(so.nbytes), int(roa.nbytes)


def dryrun_assets(mbp, tmp):
    """The dryrun's genome and reads, drawn from np.random.default_rng(11)
    exactly as the reference's body draws them (__graft_entry__.py:
    271-352): a `mbp` Mbp genome of two sequences with a 40-mer motif
    tiled x9 planted twice, its L13 index, and 160 reads of 120-200 bp,
    24 phantom-quirk reads and 16 tiled-motif reads that overflow the
    first capacity tier.  Returns (nib2 path, index path, SO bytes, ROA
    bytes, FASTA bytes of the reads)."""
    glen = mbp * 1_000_000
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", np.uint8)
    seq = bases[rng.integers(0, 4, glen)]
    motif = bases[rng.integers(0, 4, 40)]
    block = np.tile(motif, 9)
    for pos in (glen // 3, 2 * glen // 3):
        seq[pos:pos + len(block)] = block
    half = glen // 2
    fa = (b">c1\n" + bytes(seq[:half]) + b"\n>c2\n" + bytes(seq[half:]) +
          b"\n")
    gpath, xpath, so_bytes, roa_bytes = _write_genome(fa, tmp, "dryrun", 13)
    del fa
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []

    def emit(name, arr, revcomp):
        r = bytes(arr)
        if revcomp:
            r = r.translate(comp)[::-1]
        reads.append(b">%s\n%s\n" % (name, r))

    for k in range(160):
        ln = int(rng.integers(120, 201))
        pos = int(rng.integers(0, glen - ln))
        r = seq[pos:pos + ln].copy()
        m = rng.random(ln) < 0.015
        r[m] = bases[rng.integers(0, 4, int(m.sum()))]
        emit(b"rd_%d" % k, r, k % 2 == 0)
    for k in range(24):
        pre = bases[rng.integers(0, 4, 60)]
        emit(b"ph_%d" % k, np.concatenate([pre, seq[:100]]), k % 2 == 0)
    for k in range(16):
        emit(b"ov_%d" % k, np.tile(motif, 8), k % 2 == 0)
    return gpath, xpath, so_bytes, roa_bytes, b"".join(reads)


def _grid_devices(n_devices, device):
    """n_devices grid entries of the `device` kind: every card in turn
    (one card repeats), or the CPU n times."""
    import torch
    dev = _torch_device(device)
    if dev.type == "cpu":
        return ["cpu"] * n_devices
    n = torch.cuda.device_count()
    return ["cuda:%d" % (k % n) for k in range(n_devices)]


def _run_all(al, pr, batch):
    outs = []
    for lo in range(0, pr.n, batch):
        outs.append(al.align_chunk(pr, lo, min(lo + batch, pr.n))[0])
    return b"".join(outs)


def _timed_pair(al, pr, batch, sync):
    """(output, cold seconds, warm seconds) of two passes over the reads."""
    t0 = time.time()
    _run_all(al, pr, batch)
    sync()
    cold = time.time() - t0
    t0 = time.time()
    out = _run_all(al, pr, batch)
    sync()
    return out, cold, time.time() - t0


def _sync_fn(device):
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize()
    return lambda: None


def _dryrun_l15(n_devices: int, device="cuda"):
    """The composed path at the index scale that motivates sharding
    (__graft_entry__.py:47): a real L15 index (SO 4.3 GB whatever the
    genome) sharded over `model` = 4 (2 when n_devices is not a multiple
    of 4).  The index is YT_L15_DIR's big.nib2 + big.X15_01_65525S
    (default ~/hgdata), else a YT_DRYRUN_L15_MBP (default 600) Mbp
    genome built here; 1,024 reads of 500 bp at 3 % substitutions, half
    reverse-complemented.  The host-seed staged engine against the
    sharded seeder: byte identity and no host-scan fallback.  The
    reference's single seeder refuses a ROA of 2^31 entries or more; the
    port's indexes it in int64, so here the arm exercises that path.
    Returns a report; never raises (errors are reported in the report)."""
    import ctypes
    try:
        from .io import native_loader
        from .models.seeder import DeviceSeeder
        from .models.staged import StagedAligner
        from .native import host as nhost
        from .parallel import mesh as pmesh
        from .utils import codec

        t_all = time.time()
        d = os.environ.get("YT_L15_DIR", os.path.expanduser("~/hgdata"))
        gpath = os.path.join(d, "big.nib2")
        xpath = os.path.join(d, "big.X15_01_65525S")
        built = None
        tmp = None
        if not (os.path.exists(gpath) and os.path.exists(xpath)):
            t0 = time.time()
            glen = int(os.environ.get("YT_DRYRUN_L15_MBP", "600")) \
                * 1_000_000
            rng = np.random.default_rng(15)
            bases = np.frombuffer(b"ACGT", np.uint8)
            seq = bases[rng.integers(0, 4, glen)]
            half = glen // 2
            fa = (b">c1\n" + bytes(seq[:half]) + b"\n>c2\n" +
                  bytes(seq[half:]) + b"\n")
            del seq
            tmp = tempfile.mkdtemp(prefix="yt_l15_")
            gpath, xpath, _, _ = _write_genome(fa, tmp, "big", 15)
            del fa
            built = {"genome_mbp": glen // 1_000_000,
                     "build_s": round(time.time() - t0, 1)}
        genome = native_loader.load_genome(gpath)
        index = native_loader.load_index(xpath)
        assert index.word_len == 15
        so_bytes = 4 * ((1 << 30) + 1)
        roa_bytes = 4 * int(index.roa_len)
        rng = np.random.default_rng(5)
        codes_np = np.ctypeslib.as_array(
            ctypes.cast(genome.codes_buf, ctypes.POINTER(ctypes.c_uint8)),
            shape=(int(genome.codes_len),))
        n_reads, rlen = 1024, 500
        starts = genome.starting_offsets
        lens = genome.lengths
        parts = []
        for i in range(n_reads):
            c = int(rng.integers(0, len(starts)))
            pos = int(starts[c]) + int(rng.integers(
                0, max(1, int(lens[c]) - rlen)))
            r = codes_np[pos:pos + rlen].copy()
            m = (rng.random(rlen) < 0.03) & (r < 4)
            r[m] = rng.integers(0, 4, int(m.sum()))
            if rng.random() < 0.5:
                r = codec.FOUR_BIT_COMP_CODES[r][::-1]
            parts.append(b">rd%d\n%s\n" % (i, codec.unmap4to8(r).tobytes()))
        aa = _aa_for(index, 15)
        pr = nhost.parse_queries_native(b"".join(parts), False,
                                        aa.max_query_length, aa.word_len)
        model = 4 if n_devices % 4 == 0 else 2
        devices = _grid_devices(n_devices, device)
        mesh = pmesh.make_mesh(devices, model_parallel=model)
        dev0 = mesh.grid[0][0]
        sync = _sync_fn(dev0)
        batch = 512
        # The genome stays on the host for this arm (orthogonal to the
        # seed sharding; saves a multi-GB device copy).
        base = StagedAligner(aa, genome, index, device=dev0, n_threads=2,
                             device_assembly=False)
        out_base, _, t_base = _timed_pair(base, pr, batch, sync)
        t0 = time.time()
        seeder = DeviceSeeder(aa, index, mesh=mesh)
        t_shard = time.time() - t0
        multi = StagedAligner(aa, genome, index, device=dev0, n_threads=2,
                              seeder=seeder, device_assembly=False)
        out_multi, t_cold, t_multi = _timed_pair(multi, pr, batch, sync)
        ss = seeder.stats
        sidx = seeder.sidx
        so_view = seeder.iview.starting_offs
        shard_bases = [int(so_view[m * sidx.per])
                       for m in range(sidx.n_model)]
        per_shard = [sidx.shard_nbytes(m) for m in range(model)]
        report = {
            "ok": out_multi == out_base and ss["fallback_rows"] == 0,
            "byte_identical": out_multi == out_base,
            "index": {"word_len": 15, "so_bytes": so_bytes,
                      "roa_bytes": roa_bytes,
                      "roa_entries": int(index.roa_len),
                      "roa_exceeds_2_31": int(index.roa_len) >= (1 << 31),
                      "source": "prebuilt " + d if built is None
                      else "built in-process",
                      "hgdata_present": built is None},
            "built": built,
            "mesh": {"data": len(devices) // model, "model": model},
            "devices": sorted(set(devices)),
            "per_shard_so_bytes": int(per_shard[0][0]),
            "per_shard_roa_bytes": [int(b) for _, b in per_shard],
            "shard_roa_bases": shard_bases,
            "shard_bases_cross_2_31": any(b >= (1 << 31)
                                          for b in shard_bases),
            "reads": pr.n,
            "sam_records": out_multi.count(b"\n"),
            "host_seed_fallbacks": ss["fallback_rows"],
            "capacity_retries": ss["cap_retries"],
            "all_gather_bytes_per_read": round(ss["all_gather_bytes"] /
                                               (2 * pr.n)),
            "wall_s": {"host_seed_warm": round(t_base, 2),
                       "shard_construct_place": round(t_shard, 1),
                       "sharded_cold": round(t_cold, 1),
                       "sharded_warm": round(t_multi, 2),
                       "total_arm": round(time.time() - t_all, 1)},
            "sharded_vs_host_seed": round(t_multi / max(t_base, 1e-9), 2),
        }
        del seeder, multi, base
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
        return report
    except Exception as e:  # reported in-band; the main dryrun stays valid
        import traceback
        return {"ok": False, "error": "%s: %s" % (type(e).__name__, e),
                "trace": traceback.format_exc()[-1500:]}


def dryrun_multichip(n_devices: int, device="cuda"):
    """The composed product x scale-out path on an n_devices (data x
    model) grid (__graft_entry__.py:244).

    The staged engine (native host phases + the DP kernels, the gather
    and the walk on the card) with models/seeder.DeviceSeeder over
    parallel/mesh.make_mesh: the L13 index split by hash range over
    model = 2 (1 for odd n), the reads' strand rows over data =
    n_devices // model, each shard's range-masked expansion, then the
    merge of the shards' hit rows (expand_sort_kernel with hash_lo/per,
    merge_pass_kernel).  Genome and reads: dryrun_assets(YT_DRYRUN_MBP,
    default 100).  Three arms, each a cold and a warm pass over the reads
    in chunks of 100: the single-device engine with the host seed scan,
    the same with a single-device seeder, and the sharded seeder.

    Asserts: the three outputs byte-identical, no host-scan fallback row,
    phantom-quirk rows, a capacity retry and bytes merged over `model`.
    At n_devices >= 4 and YT_DRYRUN_L15 != "0" the L15 arm
    (_dryrun_l15) runs too.  Prints "dryrun_multichip ok: {json}" and
    returns the report."""
    from .io import native_loader
    from .models.seeder import DeviceSeeder
    from .models.staged import StagedAligner
    from .native import host as nhost
    from .parallel import mesh as pmesh

    devices = _grid_devices(n_devices, device)
    t0 = time.time()
    mbp = int(os.environ.get("YT_DRYRUN_MBP", "100"))
    tmp = tempfile.mkdtemp(prefix="yt_dryrun_")
    try:
        gpath, xpath, so_bytes, roa_bytes, qdata = dryrun_assets(mbp, tmp)
        genome = native_loader.load_genome(gpath)
        index = native_loader.load_index(xpath)
        t_index = time.time() - t0
        aa = _aa_for(index, 13)
        pr = nhost.parse_queries_native(qdata, False, aa.max_query_length,
                                        aa.word_len)
        model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
        mesh = pmesh.make_mesh(devices, model_parallel=model)
        dev0 = mesh.grid[0][0]
        sync = _sync_fn(dev0)
        batch = 100
        kw = dict(device=dev0, n_threads=2)
        single = StagedAligner(aa, genome, index, **kw)
        out_single, t_single_cold, t_single = _timed_pair(single, pr,
                                                          batch, sync)
        # Control arm: the device seed phase on one device (the index
        # whole), so the sharded-vs-single ratio isolates the sharding.
        seed1 = DeviceSeeder(aa, index, device=dev0)
        ctrl = StagedAligner(aa, genome, index, seeder=seed1, **kw)
        out_ctrl, t_ctrl_cold, t_ctrl = _timed_pair(ctrl, pr, batch, sync)
        seeder = DeviceSeeder(aa, index, mesh=mesh)
        multi = StagedAligner(aa, genome, index, seeder=seeder, **kw)
        out_multi, t_multi_cold, t_multi = _timed_pair(multi, pr, batch,
                                                       sync)
        assert out_ctrl == out_single, (
            "single-device seeded output differs from single-device staged")
        ss = seeder.stats
        assert ss["fallback_rows"] == 0, (
            "%d/%d strand rows fell back to the host seed scan" %
            (ss["fallback_rows"], 2 * pr.n))
        assert ss["phantom_rows"] > 0, \
            "phantom-quirk reads were not exercised on the sharded path"
        assert ss["cap_retries"] > 0, \
            "no strand row overflowed the first capacity tier"
        assert ss["all_gather_bytes"] > 0
        assert out_multi == out_single, (
            "sharded staged output differs from single-device staged")
        sidx = seeder.sidx
        per_shard = [sidx.shard_nbytes(m) for m in range(model)]
        l15 = None
        if n_devices >= 4 and os.environ.get("YT_DRYRUN_L15", "1") != "0":
            l15 = _dryrun_l15(n_devices, device)
            assert l15.get("error") or l15["ok"], l15
        report = {
            "l15": l15,
            "engine": "staged (native batch host phases + DP kernels) "
                      "with the device seed phase on the grid",
            "device": str(dev0),
            "devices": sorted(set(devices)),
            "mesh": dict(mesh.shape),
            "genome_mbp": mbp,
            "word_len": 13,
            "so_bytes": so_bytes,
            "roa_bytes": roa_bytes,
            "per_shard_so_bytes": int(per_shard[0][0]),
            "per_shard_roa_bytes": [int(b) for _, b in per_shard],
            "reads": pr.n,
            "sam_records": out_multi.count(b"\n"),
            "sam_sha256": hashlib.sha256(out_multi).hexdigest(),
            "host_seed_fallbacks": ss["fallback_rows"],
            "phantom_rows": ss["phantom_rows"],
            "capacity_retries": ss["cap_retries"],
            "seed_launches": ss["seed_launches"],
            # Stats cover both passes; per read divides by 2 * reads.
            "all_gather_bytes": ss["all_gather_bytes"],
            "all_gather_bytes_per_read": round(ss["all_gather_bytes"] /
                                               (2 * pr.n)),
            "wall_s": {"genome_index": round(t_index, 1),
                       "single_device_cold": round(t_single_cold, 2),
                       "single_device_warm": round(t_single, 2),
                       "single_device_seeded_cold": round(t_ctrl_cold, 2),
                       "single_device_seeded_warm": round(t_ctrl, 2),
                       "sharded_cold": round(t_multi_cold, 2),
                       "sharded_warm": round(t_multi, 2)},
            "sharded_vs_single_seeded": round(t_multi / max(t_ctrl, 1e-9),
                                              2),
            "byte_identical": True,
        }
        print("dryrun_multichip ok: " + json.dumps(report), flush=True)
        return report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    import argparse
    import subprocess
    import sys
    ap = argparse.ArgumentParser(description="The port's driver entry "
                                 "points: entry(), then "
                                 "dryrun_multichip(8) in a child process.")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    fn, ex = entry(args.device)
    out = fn(*ex)
    print("entry ok:", [o[:4].cpu().numpy() for o in out], flush=True)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-c", "from yaha_tpu_torch import entry; "
         "entry.dryrun_multichip(8, %r)" % args.device], cwd=repo, env=env)
    return r.returncode


if __name__ == "__main__":
    import sys
    sys.exit(main())

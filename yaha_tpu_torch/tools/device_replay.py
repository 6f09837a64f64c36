"""Measured device term of one staged chunk: its DP launch sequence replayed
as one CUDA graph, with no host work between the launches.

Counterpart of tools/device_replay.py (capture_chunk :45, build_replay
:110, _roll_window :190, measure_chunk_device :206).

  1. capture: one align_chunk runs with the port's device entry points
     wrapped to record their inputs and the scalars the host gave them:
     gather_dp.gather_problems, sw_cuda.extension_forward,
     anchored_forward_banded and anchored_forward, and decode.rle_walk.
     Each kernel call is tied to the gather whose planes it slices, each
     walk to the kernel whose plane it walks (by storage), and the walk's
     start cells are checked against the staged driver's wiring
     (models/staged.py _run_gap_bucket / _run_ext_bucket);
  2. replay: the same sequence (gather -> kernel -> walk, bucket by
     bucket, launch slice by launch slice) over static input buffers,
     captured once as a torch.cuda.CUDAGraph after a warm-up on a side
     stream (the entries allocate their outputs, which under capture come
     from the graph's private pool).  If capture fails, the same launches
     run back to back on one stream with no host read between them, and
     the report says "mode": "stream";
  3. measure: W windows of distinct inputs (every per-problem array of a
     bucket rolled by the same amount along the problem axis, as
     _roll_window does) are copied into the buffers outside the timed
     region; each replay is timed with CUDA events.  The replayed walk
     items of the unrolled window must equal the captured ones.

Left out, as in the reference: the host-coupled steps of
StagedAligner._rle_items (models/staged.py:268; the n_ops d2h, the tier
planning, gather_rle_flat and the item d2h), the strand-row upload, and
the seed phase under --seed device.  The report puts the chunk's
stats["device_s"] (host clock around every bucket) beside the replay's
device seconds and the kernels' summed time from torch.profiler over the
same chunk: the difference is the device term's host share.

On the CPU the replay runs eagerly (no graph, no timing) and must give
the captured outputs.

  python -m yaha_tpu_torch.tools.device_replay -x INDEX -q READS.fasta
      [--reads N] [--windows 5] [--device cuda|cpu] [--seed host|device]
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..ops import decode, gather_dp, sw_cuda

# The kernel entries a staged chunk calls, by module.
_KERNELS = ("extension_forward", "anchored_forward_banded",
            "anchored_forward")
LEFT_OUT = ["StagedAligner._rle_items: n_ops and scalars d2h, item-tier "
            "planning, gather_rle_flat, item d2h",
            "the chunk's strand-row upload (_chunk_rows)",
            "the seed phase (--seed device)",
            "gap buckets on the lockstep twin (gap_twin)"]
# The port's kernels as torch.profiler names them.
KERNEL_NAMES = ("ext_reg_kernel", "ext_wide_kernel", "ext_block_kernel",
                "anch_reg_kernel", "anch_wide_kernel", "gather_kernel",
                "rle_win_kernel")


def capture_chunk(aligner, pr, lo, hi):
    """Run aligner.align_chunk(pr, lo, hi) with the device entries wrapped;
    returns the recorded steps in call order, each a dict with "op" one
    of "gather", "extension_forward", "anchored_forward_banded",
    "anchored_forward", "walk", its inputs (clones) and, for the walk,
    its outputs ("rle", "n_ops")."""
    steps = []
    gathers = {}      # storage pointer of a gather's q plane -> step index
    kernel_bt = {}    # data pointer of a kernel's plane -> step index
    saved = {(gather_dp, "gather_problems"): gather_dp.gather_problems,
             (decode, "rle_walk"): decode.rle_walk}
    for name in _KERNELS:
        saved[(sw_cuda, name)] = getattr(sw_cuda, name)

    def rec_gather(rows2, codes, coords, *, qg, rg, rpad):
        q, r = saved[(gather_dp, "gather_problems")](
            rows2, codes, coords, qg=qg, rg=rg, rpad=rpad)
        steps.append({"op": "gather", "rows2": rows2, "codes": codes,
                      "coords": coords.clone(), "qg": qg, "rg": rg,
                      "rpad": rpad, "q": q, "m": coords.shape[1]})
        gathers[q.untyped_storage().data_ptr()] = len(steps) - 1
        return q, r

    def rec_kernel(name):
        def f(q, qlens, r, rlens, *more, **kw):
            src = gathers.get(q.untyped_storage().data_ptr())
            step = {"op": name, "kw": dict(kw), "n": q.shape[0],
                    "qg": q.shape[1], "rg": r.shape[1],
                    "qlens": qlens.clone(),
                    "rest": [t.clone() for t in (rlens,) + more],
                    "src": None}
            if src is not None:
                lo_ = q.storage_offset() // max(steps[src]["qg"], 1)
                step["src"] = (src, lo_, lo_ + q.shape[0])
            else:
                step["q"], step["r"] = q.clone(), r.clone()
            out = saved[(sw_cuda, name)](q, qlens, r, rlens, *more, **kw)
            step["out"] = out
            steps.append(step)
            bt = out["bt_b" if name == "anchored_forward_banded" else "bt"]
            kernel_bt[bt.data_ptr()] = len(steps) - 1
            return out
        return f

    def rec_walk(bt, y0, x0, active, *, cap, full, **kw):
        rle, n_ops = saved[(decode, "rle_walk")](bt, y0, x0, active,
                                                  cap=cap, full=full, **kw)
        k = kernel_bt.get(bt.data_ptr())
        if k is None:
            raise RuntimeError("device_replay: a walk over a plane no "
                               "captured kernel wrote")
        want = _walk_starts(steps[k])
        for label, got, w in zip(("y0", "x0", "active"),
                                 (y0, x0, active), want):
            if not torch.equal(got.to(w.dtype), w):
                raise RuntimeError("device_replay: the walk's %s is not "
                                   "the staged driver's wiring of %s"
                                   % (label, steps[k]["op"]))
        steps.append({"op": "walk", "src": k, "cap": cap, "full": full,
                      "kw": dict(kw), "rle": rle.clone(),
                      "n_ops": n_ops.clone()})
        return rle, n_ops

    gather_dp.gather_problems = rec_gather
    decode.rle_walk = rec_walk
    for name in _KERNELS:
        setattr(sw_cuda, name, rec_kernel(name))
    try:
        aligner.align_chunk(pr, lo, hi)
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    for s in steps:
        s.pop("out", None)
        if s["op"] == "gather":
            s.pop("q")
    return steps


def _walk_starts(kstep, out=None, lens=None):
    """(y0, x0, active) of the walk over a kernel's plane, as the staged
    driver wires them: from the best cell where the score is positive for
    an extension; from the corner (qlen, rlen) of the band-relative
    (x0 = rlen - qlen + lbw) or full layout for a gap fill."""
    out = kstep["out"] if out is None else out
    ql, *rest = lens if lens is not None else [kstep["qlens"]] + \
        kstep["rest"]
    if kstep["op"] == "extension_forward":
        return out["maxi"], out["maxj"], out["score"] > 0
    ones = torch.ones_like(ql, dtype=torch.bool)
    rl = rest[0]
    if kstep["op"] == "anchored_forward_banded":
        return ql, rl - ql + rest[1], ones
    return ql, rl, ones


def kernel_calls(steps):
    """The captured DP buckets, launch slices of one gather merged:
    [{"kernel", "n", "qg", "rg", "wband", "qlens", "rlens", "lbws",
    "rbws"}] with numpy int64 arrays (lbws/rbws None for an extension).
    What tests compare with the reference's capture_chunk."""
    out = []
    by_src = {}
    for s in steps:
        if s["op"] not in _KERNELS:
            continue
        arrs = [s["qlens"]] + s["rest"]
        arrs = [a.cpu().numpy().astype(np.int64) for a in arrs]
        key = s["src"][0] if s["src"] is not None else None
        if key is not None and key in by_src:
            c = out[by_src[key]]
            for k, a in zip(("qlens", "rlens", "lbws", "rbws"), arrs):
                c[k] = np.concatenate([c[k], a])
            c["n"] += s["n"]
            continue
        c = {"kernel": s["op"], "n": s["n"], "qg": s["qg"], "rg": s["rg"],
             "wband": s["kw"].get("wband"), "qlens": arrs[0],
             "rlens": arrs[1], "lbws": arrs[2] if len(arrs) > 2 else None,
             "rbws": arrs[3] if len(arrs) > 2 else None}
        if key is not None:
            by_src[key] = len(out)
        out.append(c)
    return out


class Replay:
    """The captured sequence over static input buffers: run() issues every
    step in order and returns the walk outputs [(rle, n_ops)];
    load_window(w) copies window w's rolled inputs into the buffers."""

    def __init__(self, steps):
        self.steps = steps
        self.buf = {}
        for i, s in enumerate(steps):
            if s["op"] == "gather":
                self.buf[i] = {"coords": s["coords"].clone()}
            elif s["op"] in _KERNELS:
                b = {"lens": [t.clone() for t in [s["qlens"]] + s["rest"]]}
                if s["src"] is None:
                    b["q"], b["r"] = s["q"].clone(), s["r"].clone()
                self.buf[i] = b
        self.windows = []

    def run(self):
        planes, outs, walks = {}, {}, []
        for i, s in enumerate(self.steps):
            b = self.buf.get(i)
            if s["op"] == "gather":
                planes[i] = gather_dp.gather_problems(
                    s["rows2"], s["codes"], b["coords"], qg=s["qg"],
                    rg=s["rg"], rpad=s["rpad"])
            elif s["op"] in _KERNELS:
                if s["src"] is None:
                    q, r = b["q"], b["r"]
                else:
                    g, lo, hi = s["src"]
                    q, r = planes[g][0][lo:hi], planes[g][1][lo:hi]
                lens = b["lens"]
                outs[i] = (getattr(sw_cuda, s["op"])(q, lens[0], r, *lens[1:],
                                                     **s["kw"]), lens)
            else:
                out, lens = outs[s["src"]]
                k = self.steps[s["src"]]
                bt = out["bt_b" if k["op"] == "anchored_forward_banded"
                         else "bt"]
                y0, x0, act = _walk_starts(k, out, lens)
                walks.append(decode.rle_walk(bt, y0, x0, act, cap=s["cap"],
                                             full=s["full"], **s["kw"]))
        return walks

    def make_windows(self, n_windows):
        """Window w's inputs: every per-problem array of a bucket rolled by
        (17 w) mod its problems along the problem axis (the gather's
        coordinates and its launch slices' lengths together, so a problem
        keeps its lengths); window 0 is the captured inputs.  Held on the
        device, ready to copy."""
        self.windows = []
        for w in range(n_windows):
            win = {}
            slices = {}
            for i, s in enumerate(self.steps):
                if s["op"] in _KERNELS and s["src"] is not None:
                    slices.setdefault(s["src"][0], []).append(i)
            for i, s in enumerate(self.steps):
                if s["op"] == "gather":
                    m = s["m"]
                    k = (w * 17) % max(m, 1)
                    win[i] = {"coords": torch.roll(s["coords"], k, 1)}
                    ks = sorted(slices.get(i, []),
                                key=lambda j: self.steps[j]["src"][1])
                    if not ks:
                        continue
                    bounds = [self.steps[j]["src"][1:] for j in ks]
                    if bounds[0][0] != 0 or bounds[-1][1] != m or any(
                            a[1] != b[0] for a, b in zip(bounds, bounds[1:])):
                        raise RuntimeError("device_replay: the launch "
                                           "slices of a gather do not tile "
                                           "its problems")
                    whole = [torch.roll(torch.cat(parts), k) for parts in zip(
                        *[[self.steps[j]["qlens"]] + self.steps[j]["rest"]
                          for j in ks])]
                    for j, (lo, hi) in zip(ks, bounds):
                        win[j] = {"lens": [t[lo:hi] for t in whole]}
                elif s["op"] in _KERNELS and s["src"] is None:
                    k = (w * 17) % max(s["n"], 1)
                    win[i] = {"lens": [torch.roll(t, k) for t in
                                       [s["qlens"]] + s["rest"]],
                              "q": torch.roll(s["q"], k, 0),
                              "r": torch.roll(s["r"], k, 0)}
            self.windows.append(win)

    def load_window(self, w):
        for i, b in self.windows[w].items():
            for key, v in b.items():
                if key == "lens":
                    for dst, src in zip(self.buf[i]["lens"], v):
                        dst.copy_(src)
                else:
                    self.buf[i][key].copy_(v)


def check_walks(steps, walks):
    """Raise unless the replayed walks give the captured n_ops and the
    captured items in slots [0, min(n_ops, cap))."""
    captured = [s for s in steps if s["op"] == "walk"]
    if len(captured) != len(walks):
        raise AssertionError("device_replay: %d walks replayed, %d "
                             "captured" % (len(walks), len(captured)))
    for k, (s, (rle, n_ops)) in enumerate(zip(captured, walks)):
        if not torch.equal(n_ops, s["n_ops"]):
            raise AssertionError("device_replay: walk %d: n_ops differ" % k)
        cap = s["cap"]
        keep = (torch.arange(cap, device=rle.device)[None, :] <
                torch.where(n_ops < 0, cap, n_ops).clamp(max=cap)[:, None])
        if not torch.equal(torch.where(keep, rle, 0),
                           torch.where(keep, s["rle"], 0)):
            raise AssertionError("device_replay: walk %d: items differ" % k)


def _profile_kernel_s(aligner, pr, lo, hi):
    """(all kernel seconds, seconds of the port's replayed kernels, wall
    seconds) of one align_chunk under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        aligner.align_chunk(pr, lo, hi)
        torch.cuda.synchronize()
        wall = time.time() - t0
    total = ours = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "Memcpy" in e.name or "Memset" in e.name:
            continue
        us = e.time_range.end - e.time_range.start
        total += us
        if any(k in e.name for k in KERNEL_NAMES):
            ours += us
    return total / 1e6, ours / 1e6, wall


def _entry_counts(steps):
    counts = {}
    for s in steps:
        counts[s["op"]] = counts.get(s["op"], 0) + 1
    return counts


def measure_chunk_device(aligner, pr, lo, hi, windows=5):
    """Capture and replay one chunk; returns the report (dict).  On the
    CPU the replay runs once, eagerly, and is checked; nothing is timed."""
    dev = aligner.device
    if dev.type != "cuda":
        steps = capture_chunk(aligner, pr, lo, hi)
        check_walks(steps, Replay(steps).run())
        return {"reads": hi - lo, "entry_calls": _entry_counts(steps),
                "left_out": LEFT_OUT, "mode": "eager", "walks_equal": True}
    aligner.align_chunk(pr, lo, hi)            # warm
    torch.cuda.synchronize(dev)
    for k in aligner.stats:
        aligner.stats[k] = type(aligner.stats[k])(0)
    t0 = time.time()
    aligner.align_chunk(pr, lo, hi)
    torch.cuda.synchronize(dev)
    wall = time.time() - t0
    steps = capture_chunk(aligner, pr, lo, hi)
    rep = Replay(steps)
    report = {"reads": hi - lo, "entry_calls": _entry_counts(steps),
              "left_out": LEFT_OUT, "chunk_wall_s": wall,
              "device_s": aligner.stats["device_s"]}
    sw_cuda.reset_launches()
    check_walks(steps, rep.run())
    torch.cuda.synchronize(dev)
    report["launches"] = {k: v for k, v in sw_cuda.launches().items() if v}
    report["kernel_launches"] = sum(report["launches"].values())
    rep.make_windows(windows)
    mode = "graph"
    graph = None
    try:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            rep.run()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            g_walks = rep.run()
    except Exception as e:      # reported: the stream mode, never silent
        mode = "stream"
        report["graph_error"] = "%s: %s" % (type(e).__name__, str(e)[:300])
        graph = None
        torch.cuda.synchronize(dev)
    ms = []
    for w in range(windows):
        rep.load_window(w)
        torch.cuda.synchronize(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        if graph is not None:
            graph.replay()
            walks = g_walks
        else:
            walks = rep.run()
        e1.record()
        torch.cuda.synchronize(dev)
        ms.append(e0.elapsed_time(e1))
        if w == 0:
            check_walks(steps, walks)
    srt = sorted(ms)
    med = srt[len(srt) // 2]
    kernel_s, ours_s, prof_wall = _profile_kernel_s(aligner, pr, lo, hi)
    report.update({
        "mode": mode, "windows": windows, "walks_equal": True,
        "replay_device_s_min_med_max": [srt[0] / 1e3, med / 1e3,
                                        srt[-1] / 1e3],
        "profiler_kernel_s": kernel_s,
        "profiler_replayed_kernels_s": ours_s,
        "profiler_chunk_wall_s": prof_wall,
        "host_share_s": report["device_s"] - med / 1e3,
    })
    return report


def main(argv=None):
    import argparse
    from ..config import AlignmentArgs
    from ..io import native_loader
    from ..models.seeder import DeviceSeeder
    from ..models.staged import StagedAligner
    from ..native import host
    ap = argparse.ArgumentParser(description="Replay one staged chunk's DP "
                                 "launches as a CUDA graph.")
    ap.add_argument("-x", required=True, help="index file (.nib2 beside)")
    ap.add_argument("-q", required=True, help="reads (FASTA)")
    ap.add_argument("--reads", type=int, default=16384)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", default="host", choices=("host", "device"))
    ap.add_argument("-t", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args(argv)
    genome = native_loader.load_genome(os.path.splitext(args.x)[0] +
                                       ".nib2")
    index = native_loader.load_index(args.x)
    aa = AlignmentArgs()
    aa.xfile_name, aa.qfile_name, aa.ofile_name = args.x, args.q, "out.sam"
    aa.post_process(True)
    aa.word_len = index.word_len
    aa.max_hits = min(aa.max_hits, index.max_hits)
    with open(args.q, "rb") as f:
        pr = host.parse_queries_native(f.read(), False,
                                       aa.max_query_length, aa.word_len)
    seeder = (DeviceSeeder(aa, index, device=args.device)
              if args.seed == "device" else None)
    st = StagedAligner(aa, genome, index, device=args.device,
                       n_threads=args.t, seeder=seeder)
    print(json.dumps(measure_chunk_device(st, pr, 0, min(pr.n, args.reads),
                                          windows=args.windows)))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())

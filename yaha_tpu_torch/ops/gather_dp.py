"""Device problem assembly for the staged engine: the genome and the chunk's
reads live on the device, and each DP bucket's (q, r) planes are cut there.

Counterpart of yaha_tpu/ops/gather_dp.py.  ``DeviceCorpus`` keeps the
gather signature that StagedAligner._mk_gather
(yaha_tpu/models/staged.py:635-649) calls:

  read_rows(seq, starts, lens, lpad)
                                a chunk's strand rows from its sequence
                                bytes as the parser left them: they upload
                                as they are, map to codes and gain their
                                reverse complements on the device (plain
                                PyTorch ops, one elementwise pass per
                                chunk); it takes the place of the JAX
                                corpus's chunk_rows, whose rows are coded
                                and padded on the host; the module function
                                chunk_strand_rows builds them, and the
                                device seeder calls it when the engine has
                                no corpus (models/seeder.py)
  gather(rows2, q_row, ...)     the problem planes, cut by the CUDA kernel
                                csrc/gather_kernels.cu (gather_problems)
                                from per-problem coordinates
                                (yt_batch_{gap,ext}_meta2)

The genome codes are one u8 tensor indexed in int64, so the JAX package's
2^28 paging and its PAGE_OVERLAP routing have no counterpart: every problem
is assembled on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import codec
from . import sw_cuda

# Coordinate rows of gather_problems (csrc/gather_kernels.cu C_*).
COORDS = ("q_row", "q_src", "q_copy", "qlen", "r_src", "r_copy", "rlen",
          "rev")
# Bytes of coordinates uploaded per problem (int64 rows).
COORD_BYTES = 8 * len(COORDS)


def strand_rows(fwd, lens, comp):
    """[n, lpad] u8 forward code rows + [n] lengths -> [2n, lpad] u8 rows,
    forward and reverse complement interleaved, as the native per-read
    rev_codes (rev[k] = comp[fwd[len-1-k]], code 4 past len;
    gather_dp._strand_rows)."""
    n, lpad = fwd.shape
    j = torch.arange(lpad, device=fwd.device)
    lens = lens.to(torch.int64)
    src = (lens[:, None] - 1 - j[None, :]).clamp(0, lpad - 1)
    rev = comp[torch.gather(fwd, 1, src).to(torch.int64)]
    rev = torch.where(j[None, :] < lens[:, None], rev,
                      torch.full_like(rev, 4))
    return torch.stack([fwd, rev], dim=1).reshape(2 * n, lpad)


def code_tables(device):
    """(character -> 4-bit code, code -> complement code) u8 tables on
    `device` (codec.FOUR_BIT_CODES, codec.FOUR_BIT_COMP_CODES)."""
    return tuple(torch.from_numpy(np.asarray(t, np.uint8)).to(device)
                 for t in (codec.FOUR_BIT_CODES, codec.FOUR_BIT_COMP_CODES))


def chunk_strand_rows(seq, starts, lens, lpad, tables):
    """Device [2n, lpad] strand rows of a chunk's n reads, back to back in
    seq: their sequence characters (u8), read k at [starts[k], starts[k] +
    lens[k]).  The characters upload as they are (one contiguous copy, no
    host pass) with one [2, n] int64 array of starts and lengths, and map
    to 4-bit codes on the device of `tables` (code_tables); columns past a
    read's length hold code 4."""
    codes_of, comp = tables
    dev = codes_of.device
    chars = torch.from_numpy(seq if len(seq) else
                             np.zeros(1, np.uint8)).to(dev)
    meta = torch.from_numpy(np.stack([starts, lens]).astype(
        np.int64)).to(dev)
    j = torch.arange(lpad, device=dev)
    idx = (meta[0][:, None] + j).clamp(max=chars.shape[0] - 1)
    fwd = torch.where(j < meta[1][:, None],
                      codes_of[chars[idx].to(torch.int64)], 4)
    return strand_rows(fwd.to(torch.uint8), meta[1], comp)


def gather_reference(rows2, codes, coords, *, qg, rg, rpad):
    """Plain version of gather_problems (gather_dp._gather, unpaged)."""
    q_row, q_src, q_copy, qlen, r_src, r_copy, rlen, rev = coords
    rev = rev[:, None] != 0
    nrows, lpad = rows2.shape
    dev = rows2.device

    def cut(g, length, copy, src_of):
        j = torch.arange(g, device=dev)[None, :]
        pos = torch.where(rev, length[:, None] - 1 - j, j)
        val = (j < length[:, None]) & (pos < copy[:, None])
        return torch.where(val, src_of(pos), 0).to(torch.uint8), j

    q, _ = cut(qg, qlen, q_copy, lambda pos: rows2[
        q_row.clamp(0, nrows - 1)[:, None],
        (q_src[:, None] + pos).clamp(0, lpad - 1)])
    r, jr = cut(rg, rlen, r_copy, lambda pos: codes[
        (r_src[:, None] + pos).clamp(0, codes.shape[0] - 1)])
    r = torch.where(jr < rlen[:, None], r, rpad).to(torch.uint8)
    return q, r


def gather_problems(rows2, codes, coords, *, qg, rg, rpad):
    """Assemble [m, qg] / [m, rg] u8 (q, r) planes.

    rows2: [rows, lpad] u8 strand rows; codes: [G] u8 genome codes;
    coords: [8, m] int64 rows in the order of COORDS.  Element j reads
    source position len-1-j for reversed problems, else j; positions at or
    past the copy count are 0; q past qlen is 0, r past rlen is `rpad`.
    On a CUDA tensor it launches csrc/gather_kernels.cu; on a CPU tensor it
    runs gather_reference.
    """
    if rows2.device.type == "cpu":
        return gather_reference(rows2, codes, coords, qg=qg, rg=rg,
                                rpad=rpad)
    name = "gather_problems"
    if rows2.device.type != "cuda":
        raise ValueError("%s: tensors on %s are not supported (cpu or "
                         "cuda)" % (name, rows2.device))
    for label, t, dt, dim in (("rows2", rows2, torch.uint8, 2),
                              ("codes", codes, torch.uint8, 1),
                              ("coords", coords, torch.int64, 2)):
        if (t.dtype != dt or t.dim() != dim or not t.is_contiguous()
                or t.device != rows2.device):
            raise ValueError("%s: %s must be a contiguous %d-D %s tensor on "
                             "%s" % (name, label, dim, dt, rows2.device))
    if coords.shape[0] != len(COORDS):
        raise ValueError("%s: coords must be [%d, m]" % (name, len(COORDS)))
    m = coords.shape[1]
    q = torch.empty((m, qg), dtype=torch.uint8, device=rows2.device)
    r = torch.empty((m, rg), dtype=torch.uint8, device=rows2.device)
    if m and qg + rg:
        from . import _build
        sw_cuda._launched(name, _build.load().yt_gather_problems(
            rows2.data_ptr(), rows2.shape[0], rows2.shape[1],
            codes.data_ptr(), codes.shape[0], coords.data_ptr(), m, qg, rg,
            rpad, q.data_ptr(), r.data_ptr(), sw_cuda._stream(rows2.device)))
    return q, r


def pack_coords(q_row, q_src, q_copy, qlen, r_src, r_copy, rlen, rev=None):
    """[8, m] int64 host coordinates of gather_problems (rows of COORDS)
    from the 1-D arrays of one bucket; rev None means no reversal."""
    m = len(q_row)
    coords = np.empty((len(COORDS), m), np.int64)
    for k, a in enumerate((q_row, q_src, q_copy, qlen, r_src, r_copy, rlen,
                           np.zeros(m) if rev is None else rev)):
        coords[k] = a
    return coords


class DeviceCorpus:
    """Device-resident genome codes; assembles the DP problems of a chunk."""

    def __init__(self, genome_codes: np.ndarray, device="cuda"):
        self.device = torch.device(device)
        self.codes = torch.from_numpy(np.ascontiguousarray(
            genome_codes, np.uint8)).to(self.device, copy=True)
        self.genome_bytes = int(self.codes.numel())
        self.tables = code_tables(self.device)

    def read_rows(self, seq: np.ndarray, starts: np.ndarray,
                  lens: np.ndarray, lpad: int):
        """A chunk's strand rows on the corpus's device (chunk_strand_rows).
        Returned to the caller, never stored here: the CLI's prefetch runs
        chunks concurrently, so each align_chunk call owns its rows."""
        return chunk_strand_rows(seq, starts, lens, lpad, self.tables)

    def gather(self, rows2, q_row, q_src, q_copy, qlen, r_src, r_copy,
               rlen, rev=None, *, qg, rg, rpad=0, pack=True):
        """Device (q, r) planes for one bucket; the index arrays are 1-D
        host numpy of one length m and upload as one [8, m] int64 array
        (COORD_BYTES per problem).  pack=True returns them 4-bit packed."""
        coords = pack_coords(q_row, q_src, q_copy, qlen, r_src, r_copy,
                             rlen, rev)
        q, r = gather_problems(rows2, self.codes,
                               torch.from_numpy(coords).to(self.device),
                               qg=int(qg), rg=int(rg), rpad=int(rpad))
        if pack:
            q = q[:, ::2] | (q[:, 1::2] << 4)
            r = r[:, ::2] | (r[:, 1::2] << 4)
        return q, r

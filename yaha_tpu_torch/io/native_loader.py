"""numpy-free genome/index loaders for the native engine.

The port's copy of yaha_tpu/io/native_loader.py; the codes unpack through
the port's own native library.

The native per-read pipeline (yt_align_batch) only needs raw pointers;
loading through numpy costs ~0.33s of import time alone, which is the
bulk of cold-start for short runs.  These loaders parse the nib2 header
with struct, unpack codes through the native library, and mmap the index
read-only (ACCESS_COPY gives a ctypes-addressable buffer without copying
pages that are never written).

Formats: nib2 per Compress.c:25-134, index per Index.c:161-194.
"""
from __future__ import annotations

import ctypes
import mmap
import struct

NIB2_MARKER = 0x01020304


class NativeGenome:
    """Duck-types Genome for sam.file_header + the native align path."""

    __slots__ = ("names", "starting_offsets", "lengths", "codes_buf",
                 "codes_len", "max_roff", "_starts_arr", "_lens_arr",
                 "_names_blob", "_name_offs", "_mm_refs")

    @property
    def n_seqs(self):
        return len(self.names)


def load_genome(path: str) -> NativeGenome:
    import os
    from ..native import host
    lib = host._load()
    nib2_size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(16)
        magic, version, base_off, seq_count = struct.unpack_from(
            "<IIII", head, 0)
        if magic != NIB2_MARKER or version not in (1, 2):
            raise ValueError("Input nib2 file bad header format.")
        # Preamble (headers + names) only; the 4-bit payload is read
        # lazily -- not at all when the unpacked-codes sidecar is fresh.
        preamble = f.read(base_off - 16)
    data = head + preamble
    _ = data
    if magic != NIB2_MARKER or version not in (1, 2):
        raise ValueError("Input nib2 file bad header format.")
    bs_block = 12 if version == 1 else 16
    name_start = 16 + bs_block * seq_count + 4
    g = NativeGenome()
    g.names = []
    g.starting_offsets = []
    g.lengths = []
    for i in range(seq_count):
        off = 16 + bs_block * i
        if version == 1:
            s, ln, ninfo = struct.unpack_from("<III", data, off)
            noff, nlen = (ninfo >> 16) & 0xFFFF, ninfo & 0xFFFF
        else:
            s, ln, noff, nlen = struct.unpack_from("<IIII", data, off)
        g.starting_offsets.append(s * 2)  # bytes -> bases (normalize)
        g.lengths.append(ln)
        g.names.append(data[name_start + noff:name_start + noff + nlen]
                       .decode("latin-1"))
    n_codes = 2 * (nib2_size - base_off)
    # +8192 zero codes: the reference's mmap zero page past EOF
    # (io/nib2.py load; fuzz seed 12247).
    #
    # The unpacked code array is cached in a sidecar (<nib2>.codes) and
    # mmap'd on reuse: at 3 Gbp the unpack costs ~5 s per run, while the
    # reference's raw mmap is instant -- the sidecar restores that
    # (OS page cache shares it across processes, like the reference's
    # shared index mmap).
    codes_path = path + ".codes"
    total_len = n_codes + 8192
    use_cache = False
    try:
        st = os.stat(codes_path)
        use_cache = (st.st_size == total_len and
                     st.st_mtime >= os.path.getmtime(path))
    except OSError:
        pass
    if use_cache:
        f2 = open(codes_path, "rb")
        mm = mmap.mmap(f2.fileno(), 0, access=mmap.ACCESS_COPY)
        g.codes_buf = (ctypes.c_char * total_len).from_buffer(mm)
        g._mm_refs = (mm, f2)
    else:
        with open(path, "rb") as f:
            f.seek(base_off)
            packed = f.read()
        g.codes_buf = ctypes.create_string_buffer(total_len)
        lib.yt_unpack_nib2(
            ctypes.cast(ctypes.c_char_p(packed),
                        ctypes.POINTER(ctypes.c_uint8)),
            len(packed),
            ctypes.cast(g.codes_buf, ctypes.POINTER(ctypes.c_uint8)))
        g._mm_refs = None
        try:
            tmp = codes_path + ".tmp.%d" % os.getpid()
            with open(tmp, "wb") as f2:
                f2.write(memoryview(g.codes_buf))
            os.replace(tmp, codes_path)
        except OSError:
            pass     # read-only dir: just skip the cache
    g.codes_len = total_len
    g.max_roff = (g.starting_offsets[-1] + g.lengths[-1]
                  if seq_count else 0)
    g._starts_arr = (ctypes.c_int64 * seq_count)(*g.starting_offsets)
    g._lens_arr = (ctypes.c_int64 * seq_count)(*g.lengths)
    blob = "".join(g.names).encode("latin-1")
    g._names_blob = ctypes.create_string_buffer(blob, len(blob) + 1)
    offs = [0]
    for nm in g.names:
        offs.append(offs[-1] + len(nm))
    g._name_offs = (ctypes.c_int64 * (seq_count + 1))(*offs)
    return g


class NativeIndex:
    __slots__ = ("word_len", "max_hits", "total_matches", "so_ptr",
                 "roa_ptr", "roa_len", "_mm", "_f")


def load_index(path: str) -> NativeIndex:
    idx = NativeIndex()
    f = open(path, "rb")
    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    version, word_len, max_hits, total_matches = struct.unpack_from(
        "<IIII", mm, 0)
    if version != 0xFFFFFFFF:
        raise ValueError("Index file version is out of date.\n"
                         "Please remake index file and try again.")
    idx.word_len = word_len
    idx.max_hits = max_hits
    idx.total_matches = total_matches
    base = ctypes.addressof(ctypes.c_char.from_buffer(mm))
    ht_size = 1 << (2 * word_len)
    idx.so_ptr = ctypes.cast(base + 16, ctypes.POINTER(ctypes.c_uint32))
    idx.roa_ptr = ctypes.cast(base + 16 + 4 * (ht_size + 1),
                              ctypes.POINTER(ctypes.c_uint32))
    idx.roa_len = (mm.size() - 16 - 4 * (ht_size + 1)) // 4
    idx._mm = mm
    idx._f = f
    return idx

"""SAM / Blast8 output, byte-exact with the reference writer.

Frozen copy of the port's io/sam.py (yaha_tpu_torch): outputFileHeader / printClump
(AlignOutput.c:30-321).  @PG records the fully-specified effective config
(user-mode flag set).  print_clump writes the oracle engine's records (the
other engines' come from the native library): CIGAR merges M/R, clips are
appended to the edit-op list at print time, the MD tag carries the
samtools '0'-after-delete hack, and YF/YI/YP/YS tags expose clump status.
"""
from __future__ import annotations

from .core.editops import (MATCH, REPLACE, DELETE, HARD_CLIP,
                            SOFT_CLIP)

BUILD_NUM = 83  # version string parity with the reference build


def file_header(aa, genome, user_mode=True) -> str:
    if not aa.output_sam:
        return ""
    out = ["@HD\tVN:1.0\n"]
    for i in range(genome.n_seqs):
        out.append("@SQ\tSN:%s\tLN:%u\n" % (genome.names[i],
                                            int(genome.lengths[i])))
    cl = ["@PG\tID:YAHA\tVN:0.1.%d\tCL:yaha" % BUILD_NUM]
    cl.append(" -q %s" % aa.qfile_name)
    cl.append(" -x %s" % aa.xfile_name)
    if aa.output_blast8:
        cl.append(" -o8")
    else:
        cl.append(" -os%c" % ("h" if aa.hard_clip else "s"))
    cl.append(" %s" % aa.ofile_name)
    cl.append(" -t %d" % aa.num_threads)
    cl.append(" -BW %d" % aa.band_width)
    cl.append(" -G %d" % aa.max_gap)
    cl.append(" -H %d" % aa.max_hits)
    if not user_mode:
        cl.append(" -I %d" % aa.max_intron)
    cl.append(" -M %d" % aa.min_match)
    cl.append(" -MD %d" % aa.max_desert)
    cl.append(" -P %4.2f" % aa.min_identity)
    if not user_mode:
        cl.append(" -R %d" % aa.min_raw_score)
    cl.append(" -X %d" % aa.x_cutoff)
    if aa.affine_gap_scoring:
        cl.append(" -AGS Y")
        cl.append(" -GEC %d" % aa.ge_cost)
        cl.append(" -GOC %d" % aa.go_cost)
        cl.append(" -MS %d" % aa.m_score)
        cl.append(" -RC %d" % aa.r_cost)
    else:
        cl.append(" -AGS N")
    if aa.oqc:
        cl.append(" -OQC Y")
        cl.append(" -BP %d" % aa.bp_cost)
        cl.append(" -MGDP %d" % aa.max_bp_log)
        cl.append(" -MNO %d" % aa.oqc_min_non_overlap)
        if aa.fbs:
            cl.append(" -FBS Y")
            cl.append(" -PRL %4.2f" % aa.fbs_ps_length)
            cl.append(" -PSS %4.2f" % aa.fbs_ps_score)
        else:
            cl.append(" -FBS N")
    else:
        cl.append(" -OQC N")
    out.append("".join(cl) + "\n")
    return "".join(out)


def print_clump(clump, aa, qs) -> str:
    """printClump (AlignOutput.c:115-321).  Returns the output text
    ("" when the alignment spans base sequences and is dropped)."""
    from . import codec
    frag0 = clump.first_frag
    fragn = clump.last_frag
    seq_start = frag0.sro
    seq_end = fragn.ero
    genome = qs.genome
    bs_num = genome.find_seq_num(seq_start)
    if bs_num < 0 or seq_end >= (int(genome.starting_offsets[bs_num]) +
                                 int(genome.lengths[bs_num])):
        return ""
    bs_start = int(genome.starting_offsets[bs_num])
    seq_start -= bs_start
    seq_end -= bs_start
    name = genome.names[bs_num]
    query_buf = qs.clump_query_buf(clump)
    out = []

    if aa.output_sam:
        out.append("%s\t%d\t%s\t%u\t%u\t" % (
            qs.query_id, 0x10 if clump.reversed else 0x00, name,
            seq_start + 1, clump.map_quality))
        lst = clump.eol
        # Clips appended at print time (AlignOutput.c:165-171); frag0 spans
        # the whole alignment at this point (single collapsed SFragment).
        clip = qs.query_len - 1 - frag0.eqo
        if clip > 0:
            lst.add_back(HARD_CLIP if aa.hard_clip else SOFT_CLIP, clip)
        clip = frag0.sqo
        if clip > 0:
            lst.add_front(HARD_CLIP if aa.hard_clip else SOFT_CLIP, clip)

        # CIGAR: M/R merged.
        matches = 0
        for op, length in lst.items:
            if op in (MATCH, REPLACE):
                matches += length
                continue
            if matches > 0:
                out.append("%dM" % matches)
                matches = 0
            out.append("%d%c" % (length, op))
        if matches > 0:
            out.append("%dM" % matches)

        out.append("\t*\t0\t0\t")
        qstart = 0
        qend = qs.query_len - 1
        if aa.hard_clip:
            qstart = frag0.sqo
            qend = fragn.eqo
        out.append(query_buf[qstart:qend + 1].tobytes().decode("latin-1"))
        out.append("\t")
        if aa.fastq:
            if clump.reversed:
                out.append(qs.qual[qstart:qend + 1][::-1].tobytes()
                           .decode("latin-1"))
            else:
                out.append(qs.qual[qstart:qend + 1].tobytes()
                           .decode("latin-1"))
        else:
            out.append("*")
        out.append("\t")
        out.append("AS:i:%d\t" % clump.tot_score)
        out.append("NM:i:%d\t" % (clump.gap_bases + clump.mismatched_bases))
        out.append("MD:Z:")
        matches = 0
        previous = "U"
        cur_ref = frag0.sro
        gcodes = qs.genome_codes
        for op, length in lst.items:
            if op == MATCH:
                matches += length
                cur_ref += length
            elif op == REPLACE:
                if matches > 0:
                    out.append("%d" % matches)
                    matches = 0
                if previous == DELETE:
                    out.append("0")
                out.append(codec.unmap4to8(gcodes[cur_ref:cur_ref + length])
                           .tobytes().decode("latin-1"))
                cur_ref += length
            elif op == DELETE:
                if matches > 0:
                    out.append("%d" % matches)
                    matches = 0
                out.append("^")
                out.append(codec.unmap4to8(gcodes[cur_ref:cur_ref + length])
                           .tobytes().decode("latin-1"))
                cur_ref += length
            previous = op
        if matches > 0:
            out.append("%d" % matches)
        out.append("\tYF:H:%02X" % clump.status)
        if aa.oqc:
            out.append("\tYI:i:%d" % clump.matched_primary)
            out.append("\tYP:i:%d" % qs.primary_count)
            if clump.primary:
                out.append("\tYS:i:%d" % clump.num_secondaries)
        out.append("\n")

    if aa.output_blast8:
        percent = 0.8
        out.append("%s\t%s" % (qs.query_id, name))
        out.append("\t%4.2f\t%d\t%d\t%d" % (percent * 100, clump.tot_length,
                                            clump.mismatched_bases,
                                            clump.gap_bases))
        if clump.reversed:
            out.append("\t%d\t%d\t%d\t%d\t%c" % (
                qs.query_len - fragn.eqo, qs.query_len - frag0.sqo,
                seq_end + 1, seq_start + 1, "-"))
        else:
            out.append("\t%d\t%d\t%d\t%d\t%c" % (
                frag0.sqo + 1, fragn.eqo + 1, seq_start + 1, seq_end + 1,
                "+"))
        out.append("\t%d\t%d\t%4.2f\n" % (
            clump.tot_score, qs.query_len,
            (clump.matched_bases / qs.query_len) * 100))

    return "".join(out)

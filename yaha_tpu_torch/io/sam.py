"""SAM header, byte-exact with the reference writer.

The port's copy of file_header from yaha_tpu/io/sam.py (outputFileHeader,
AlignOutput.c:30-113): @PG records the fully-specified effective config
(user-mode flag set).  The records themselves come from the native
library.
"""
from __future__ import annotations

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

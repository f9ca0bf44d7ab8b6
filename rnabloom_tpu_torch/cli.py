"""Command-line entry point of the PyTorch/CUDA port.

The JAX package's option names (RNABloom.java:5839-6410) for the part of
the paired-end path that is ported: stage 0, the stage-1 graph build,
stage-2 fragment assembly (with ``-extend``) and stage 3's transcripts
with the non-redundant pass (``transcripts.nr.fa``; ``-norr`` skips it),
with ``-savebf`` to save the graph.  ``-rescue`` and ``-sef``/``-ser`` are
accepted and refused.  ``--device`` picks the torch device (default
``cuda``); asking for CUDA where there is none raises.

    python -m rnabloom_tpu_torch.cli -left r1.fq -right r2.fq -revcomp-right -o out/
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rnabloom-tpu-torch",
        description="PyTorch/CUDA port of rnabloom-tpu (paired-end stages 1-3)",
    )
    p.add_argument("-left", "--left", required=True, help="left read file (FASTQ/FASTA, gz ok)")
    p.add_argument("-right", "--right", required=True, help="right read file")
    p.add_argument("-revcomp-left", action="store_true", help="reverse-complement left reads")
    p.add_argument(
        "-revcomp-right", action="store_true", default=True,
        help="reverse-complement right reads [true]",
    )
    p.add_argument("-sef", "--sef", nargs="*", help="single-end forward reads (not ported: refused)")
    p.add_argument("-ser", "--ser", nargs="*", help="single-end reverse reads (not ported: refused)")
    p.add_argument("-ref", "--ref", nargs="*", help="reference transcripts to augment the graph")
    p.add_argument("-o", "--outdir", default="rnabloom_out", help="output directory")
    p.add_argument("-n", "--name", default="rnabloom", help="assembly name (output file prefix) [rnabloom]")
    p.add_argument("-k", "--kmer", type=int, default=25, help="k-mer size [25]")
    p.add_argument("-q", "--qual", type=int, default=3, help="min base quality [3]")
    p.add_argument("-Q", "--qual-avg", dest="qual_avg", type=int, default=0, help="min average read quality [0]")
    p.add_argument("-stranded", "--stranded", action="store_true", help="strand-specific reads")
    p.add_argument("-mem", "--mem", type=float, default=1.0, help="Bloom memory budget (GB) [1]")
    p.add_argument("-length", "--length", type=int, default=200, help="min transcript length [200]")
    p.add_argument("-overlap", "--overlap", type=int, default=10, help="min read overlap [10]")
    p.add_argument("-bound", "--bound", type=int, default=500, help="max gap walk length [500]")
    p.add_argument("-hash", "--hash", type=int, default=2, help="hash functions per filter [2]")
    p.add_argument("-sh", "--sbf-hash", dest="sbf_hash", type=int, default=0,
                   help="hash functions for the screening Bloom filter [=hash]")
    p.add_argument("-dh", "--dbgbf-hash", dest="dbgbf_hash", type=int, default=0,
                   help="hash functions for the de Bruijn graph Bloom filter [=hash]")
    p.add_argument("-ch", "--cbf-hash", dest="cbf_hash", type=int, default=0,
                   help="hash functions for the k-mer counting filter [=hash]")
    p.add_argument("-ph", "--pkbf-hash", dest="pkbf_hash", type=int, default=0,
                   help="hash functions for the paired-k-mers Bloom filter [=hash]")
    p.add_argument("-sm", "--sbf-mem", dest="sbf_mem", type=float, default=0,
                   help="memory (GB) for the screening Bloom filter [auto]")
    p.add_argument("-dm", "--dbgbf-mem", dest="dbgbf_mem", type=float, default=0,
                   help="memory (GB) for the de Bruijn graph Bloom filter [auto]")
    p.add_argument("-cm", "--cbf-mem", dest="cbf_mem", type=float, default=0,
                   help="memory (GB) for the k-mer counting filter [auto]")
    p.add_argument("-pm", "--pkbf-mem", dest="pkbf_mem", type=float, default=0,
                   help="memory (GB) for the paired-k-mers Bloom filter [auto]")
    p.add_argument("-cnt", "--counter", choices=("mf8", "u16", "int32"), default="mf8",
                   help="counter cell width: mf8 = 1 B/cell MiniFloat, u16/int32 = exact [mf8]")
    p.add_argument("-fpr", "--fpr", type=float, default=0.01,
                   help="max allowable Bloom filter FPR; breach resizes + rebuilds [0.01]")
    p.add_argument("-nk", "--nk", type=int, default=0,
                   help="expected number of distinct k-mers (sizes filters at 1%% FPR)")
    p.add_argument("-batch", "--batch", type=int, default=8192, help="stage-2 pair batch size")
    p.add_argument("-c", "--mincov", type=float, default=1,
                   help="minimum k-mer coverage [1]")
    p.add_argument("-e", "--errcorritr", type=int, default=2,
                   help="error-correction iterations per read [2]")
    p.add_argument("-grad", "--maxcovgrad", type=float, default=0.50,
                   help="max k-mer coverage gradient for error correction [0.50]")
    p.add_argument("-indel", "--indel", type=int, default=1,
                   help="max size of indels to be collapsed [1]")
    p.add_argument("-p", "--percent", type=float, default=0.90,
                   help="min percent identity of sequences to be collapsed [0.90]")
    p.add_argument("-lookahead", "--lookahead", type=int, default=3,
                   help="k-mers to look ahead during graph traversal [3]")
    p.add_argument("-tiplength", "--tiplength", type=int, default=-1,
                   help="max number of bases in a tip [auto]")
    p.add_argument("-extend", "--extend", action="store_true",
                   help="extend fragments outward during fragment reconstruction")
    p.add_argument("-rescue", "--rescue", action="store_true",
                   help="retry unconnected read pairs (not ported: refused)")
    p.add_argument("-nofc", "--nofc", action="store_true",
                   help="turn off assembly consistency with fragment paired k-mers")
    p.add_argument("-artifact", "--artifact", action="store_true",
                   help="keep potential sequencing artifacts")
    p.add_argument("-chimera", "--chimera", action="store_true",
                   help="keep potential chimeras")
    p.add_argument("-stratum", "--stratum", default="e0",
                   choices=("01", "e0", "e1", "e2", "e3", "e4", "e5"),
                   help="fragments below this stratum extend only if branch-free [e0]")
    p.add_argument("-a", "--polya", type=int, default=0,
                   help="prioritize poly-A transcripts with tails of this min length [0]")
    p.add_argument("-maxclip", "--max-edge-clip", dest="max_edge_clip", type=int, default=0,
                   help="max end clip for blunt-end artifact screening (0 = off)")
    p.add_argument("-ts", "--template-switch", dest="template_switch", action="store_true",
                   help="screen template-switch artifacts (stranded mode)")
    p.add_argument("-u", "--uracil", action="store_true",
                   help="write transcripts as RNA (U instead of T)")
    p.add_argument("-prefix", "--prefix", default="",
                   help="name prefix in FASTA headers for assembled transcripts")
    p.add_argument("-norr", "--norr", action="store_true",
                   help="skip redundancy reduction (no transcripts.nr.fa)")
    p.add_argument("-sample", "--sample", type=int, default=1000,
                   help="sample size for read/fragment length estimation [1000]")
    p.add_argument("-stage", "--stage", type=int, default=3, choices=(1, 2, 3),
                   help="assembly termination stage: 1=graph, 2=fragments, 3=transcripts [3]")
    p.add_argument("-savebf", "--savebf", action="store_true", help="save graph Bloom filters for resume")
    p.add_argument("-f", "--force", action="store_true", help="overwrite (ignore stage stamps)")
    p.add_argument("--device", default="cuda", help="torch device to run on [cuda]")
    return p


def run(argv=None):
    """Parse ``argv``, run the pipeline and return its PipelineReport."""
    args = build_parser().parse_args(argv)
    from .assembly import pipeline
    from .graph import engine

    device = engine.require_device(args.device)

    params = pipeline.PipelineParams(
        k=args.kmer,
        stranded=args.stranded,
        min_qual=args.qual,
        min_avg_qual=args.qual_avg,
        total_mem_bytes=int(args.mem * (1 << 30)),
        num_hash=args.hash,
        min_transcript_length=args.length,
        max_edge_clip=args.max_edge_clip,
        template_switch_filter=args.template_switch,
        write_uracil=args.uracil,
        header_prefix=args.prefix,
        no_reduce=args.norr,
        frag_consistency=not args.nofc,
        keep_artifacts=args.artifact,
        keep_chimeras=args.chimera,
        branch_free_stratum=args.stratum,
        polya_min_len=args.polya,
        sbf_hash=args.sbf_hash,
        sbf_mem_bytes=int(args.sbf_mem * (1 << 30)),
        expected_num_kmers=args.nk,
        max_fpr=args.fpr,
        name=args.name,
        stop_stage=args.stage,
        dbgbf_hash=args.dbgbf_hash,
        cbf_hash=args.cbf_hash,
        pkbf_hash=args.pkbf_hash,
        dbgbf_mem_bytes=int(args.dbgbf_mem * (1 << 30)),
        cbf_mem_bytes=int(args.cbf_mem * (1 << 30)),
        pkbf_mem_bytes=int(args.pkbf_mem * (1 << 30)),
        counter=args.counter,
        batch_size=args.batch,
        min_overlap=args.overlap,
        bound=args.bound,
        sample_size=args.sample,
        err_corr_iters=args.errcorritr,
        max_indel=args.indel,
        min_kmer_cov=args.mincov,
        max_cov_gradient=args.maxcovgrad,
        percent_identity=args.percent,
        lookahead=args.lookahead,
        max_tip_length=args.tiplength,
        extend_fragments=args.extend,
        rescue_unconnected=args.rescue,
        verbose=True,
    )
    return pipeline.assemble_pe(
        args.left, args.right, args.outdir, params,
        revcomp_left=args.revcomp_left, revcomp_right=args.revcomp_right,
        save_graph=args.savebf, force=args.force, device=device,
        sef_paths=args.sef or (), ser_paths=args.ser or (), ref_paths=args.ref or (),
    )


def main(argv=None) -> int:
    report = run(argv)
    print(json.dumps({
        "pairs": report.num_pairs,
        "fragments": report.num_fragments,
        "transcripts": report.num_transcripts,
        "short": report.num_short,
        "nr": report.num_nr,
        "elapsed_s": round(report.elapsed_s, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

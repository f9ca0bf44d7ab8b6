"""Command-line entry point of the PyTorch/CUDA port.

The JAX package's option names, defaults and dispatch (its ``cli.py``;
RNABloom.java:5839-6410): paired-end (``-left``/``-right``, with
``-sef``/``-ser`` mixed in and ``-rescue``), single-end (``-sef``/``-ser``
alone) and pooled (``-pool READSLIST``, ``-mergepool``), stages 1-3 with
the non-redundant pass (``transcripts.nr.fa``; ``-norr`` skips it), and
long reads (``-long`` with ``-lrsub``, ``-rc``, ``-lrpb`` (k=35 unless
``-k`` is given), ``-lrop``, ``-lrrd``, ``-m``, ``-mw``, ``-sop``,
``-son``, ``-paf`` and ``-pafin``; ``-hpc`` only sets its parameter, which
no path reads, and ``-mmopt`` is ignored with a note).  ``-k`` takes a
list or range and picks the k with the most non-singleton k-mers in a
read sample; ``-hist`` and ``-ntcard`` size the filters when ``-nk`` is 0;
an input given as ``@FILE`` expands to the paths listed in FILE.  The
multi-host flags are accepted and refused, naming their ROADMAP item.
``--device`` picks the torch device (default ``cuda``); asking for CUDA
where there is none raises.

    python -m rnabloom_tpu_torch.cli -left r1.fq -right r2.fq -revcomp-right -o out/
    python -m rnabloom_tpu_torch.cli -sef se.fq -o out/
    python -m rnabloom_tpu_torch.cli -pool samples.txt -mergepool -o out/
    python -m rnabloom_tpu_torch.cli -long ont.fa -o out/
"""

from __future__ import annotations

import argparse
import json
import sys

from . import __version__

# the JAX CLI's multi-host flags (ROADMAP queue-1 item 14): (names, dest,
# values that run, kwargs).  The first of the values is the default; any
# other value is refused before any work is done.  The port is the
# single-device engine, so -sharded off runs.
_REFUSED = (
    (("-sharded", "--sharded"), "sharded", ("auto", "off"),
     dict(choices=("auto", "on", "off"), help="multi-device scale-out")),
    (("-coordinator", "--coordinator"), "coordinator", ("",), dict(help="multi-host coordinator HOST:PORT")),
    (("-nprocs", "--nprocs"), "nprocs", (1,), dict(type=int, help="multi-host: number of processes")),
    (("-procid", "--procid"), "procid", (0,), dict(type=int, help="multi-host: this process's id")),
    (("-mhlayout", "--mh-layout"), "mh_layout", ("auto",),
     dict(choices=("auto", "local", "sharded"), help="multi-host graph layout")),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rnabloom-tpu-torch",
        description="PyTorch/CUDA port of rnabloom-tpu (paired-end, single-end, pooled and long reads)",
    )
    p.add_argument("-left", "--left", help="left read file (FASTQ/FASTA, gz ok)")
    p.add_argument("-right", "--right", help="right read file")
    p.add_argument("-revcomp-left", action="store_true", help="reverse-complement left reads")
    p.add_argument(
        "-revcomp-right", action="store_true", default=True,
        help="reverse-complement right reads [true]",
    )
    p.add_argument("-sef", "--sef", nargs="*", help="single-end forward reads")
    p.add_argument("-ser", "--ser", nargs="*", help="single-end reverse reads")
    p.add_argument("-pool", "--pool", help="pooled multi-sample READSLIST file")
    p.add_argument("-ref", "--ref", nargs="*", help="reference transcripts to augment the graph")
    p.add_argument("-o", "--outdir", default="rnabloom_out", help="output directory")
    p.add_argument("-n", "--name", default="rnabloom", help="assembly name (output file prefix) [rnabloom]")
    p.add_argument("-k", "--kmer", default="25", help="k-mer size, list, or range e.g. '25,26,30-50:5' [25]")
    p.add_argument("-q", "--qual", type=int, default=3, help="min base quality [3]")
    p.add_argument("-Q", "--qual-avg", dest="qual_avg", type=int, default=0, help="min average read quality [0]")
    p.add_argument("-stranded", "--stranded", action="store_true", help="strand-specific reads")
    p.add_argument("-mem", "--mem", type=float, default=1.0, help="Bloom memory budget (GB) [1]")
    p.add_argument("-length", "--length", type=int, default=200, help="min transcript length [200]")
    p.add_argument("-overlap", "--overlap", type=int, default=10, help="min read overlap [10]")
    p.add_argument("-bound", "--bound", type=int, default=500, help="max gap walk length [500]")
    p.add_argument("-pair", "--pair", type=int, default=10, help="min k-mer pairs [10]")
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
    p.add_argument("-t", "--threads", type=int, default=2, help="(accepted for compat; unused)")
    p.add_argument("-sensitive", "--sensitive", action="store_true", help="sensitive preset (lower thresholds)")
    p.add_argument("-mergepool", "--mergepool", action="store_true", help="merge pooled per-sample assemblies")
    p.add_argument("-hist", "--hist", default="", help="ntCard-format .hist file: sizes filters from its F0")
    p.add_argument("-ntcard", "--ntcard", action="store_true",
                   help="estimate distinct k-mers with the internal sketch for exact filter sizing")
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
                   help="retry unconnected read pairs against the fragment graph")
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
    p.add_argument("-debug", "--debug", action="store_true", help="print debugging information")
    p.add_argument("-v", "--version", action="version", version=f"rnabloom-tpu-torch {__version__}")
    p.add_argument("--device", default="cuda", help="torch device to run on [cuda]")
    p.add_argument("-long", "--long", dest="long_reads", nargs="*", help="long reads (ONT)")
    p.add_argument("-lrop", "--lrop", type=float, default=0.0,
                   help="min matching-base proportion in long-read overlaps (identity proxy) [off]")
    p.add_argument("-lrpb", "--lrpb", action="store_true", help="long reads are PacBio (preset k=35)")
    p.add_argument("-lrrd", "--lrrd", type=int, default=0, help="min read depth for long-read assembly [auto]")
    p.add_argument("-lrsub", "--lrsub", default="",
                   help="subsample long reads: 'depth,s,size,window' (strobemers) or 'depth,k,size' (k-mers)")
    p.add_argument("-rc", "--revcomp-long", dest="revcomp_long", action="store_true",
                   help="reverse-complement long reads")
    p.add_argument("-m", "--minimizer", dest="minimizer", type=int, default=0, help="OLC minimizer size [=k]")
    p.add_argument("-mw", "--minimizer-window", dest="minimizer_window", type=int, default=0,
                   help="OLC minimizer window size [10]")
    p.add_argument("-sop", "--sketch-overlap-proportion", dest="sop", type=float, default=0.0,
                   help="min proportion of sketch overlap minimizers [off]")
    p.add_argument("-son", "--sketch-overlap-number", dest="son", type=int, default=0,
                   help="min number of sketch overlap minimizers [4]")
    p.add_argument("-hpc", "--hpc", action="store_true",
                   help="homopolymer-compressed minimizers in long-read clustering")
    p.add_argument("-mmopt", "--mmopt", default="",
                   help="(accepted for compat; the internal overlapper replaces minimap2)")
    p.add_argument("-paf", "--paf", action="store_true", help="long reads: also write the all-vs-all overlaps as PAF")
    p.add_argument("-pafin", "--pafin", default="",
                   help="long reads: use this external all-vs-all PAF (reads named lr.<i>) instead of the "
                        "internal overlapper")
    refused = p.add_argument_group("refused", "multi-host options of the JAX CLI, not ported yet")
    for names, dest, runs, kw in _REFUSED:
        refused.add_argument(*names, dest=dest, default=runs[0], **kw)
    return p


def _expand_at(paths):
    """`@file` list indirection (RNABloom.java:5786-5792): an input given
    as @list.txt expands to the non-empty lines of list.txt."""
    if paths is None:
        return None
    single = isinstance(paths, str)
    out = []
    for p in [paths] if single else paths:
        if p and p.startswith("@"):
            with open(p[1:]) as f:
                out.extend(ln.strip() for ln in f if ln.strip())
        else:
            out.append(p)
    if single:
        if len(out) != 1:
            raise SystemExit("@list for a single-file option must contain exactly one path")
        return out[0]
    return out


def run(argv=None):
    """Parse ``argv`` and run the entry point it asks for: a
    PipelineReport, {sample: PipelineReport} for ``-pool``, or None (after
    an error message) when no reads were given."""
    args = build_parser().parse_args(argv)
    for names, dest, runs, _ in _REFUSED:
        if getattr(args, dest) not in runs:
            raise NotImplementedError(f"{names[0]} is not ported yet: ROADMAP queue-1 item 14")
    for attr in ("left", "right", "sef", "ser", "long_reads"):
        setattr(args, attr, _expand_at(getattr(args, attr)))
    if not (args.pool or args.long_reads or (args.left and args.right) or args.sef or args.ser):
        print("error: provide -left/-right (PE) or -sef/-ser (SE)", file=sys.stderr)
        return None
    from .assembly import pipeline
    from .graph import engine
    from .utils import kselect

    device = engine.require_device(args.device)
    # probe reads of -k LIST and -ntcard: the long reads, else the pairs,
    # else the unpaired reads
    probe = (list(args.long_reads or []) or [p for p in (args.left, args.right) if p]
             or list(args.sef or []) + list(args.ser or []))
    k_values = kselect.parse_k_spec(str(args.kmer))
    if len(k_values) > 1:
        k = kselect.select_k(probe, k_values, device=device)
        print(f"selected k={k} from {k_values}")
    else:
        k = k_values[0]
    if args.long_reads and args.lrpb and str(args.kmer) == "25":
        k = 35  # PacBio preset (RNABloom.java:6317-6332)

    params = pipeline.PipelineParams(
        k=k,
        stranded=args.stranded,
        min_qual=args.qual,
        min_avg_qual=args.qual_avg,
        total_mem_bytes=int(args.mem * (1 << 30)),
        num_hash=args.hash,
        min_num_kmer_pairs=args.pair,
        min_transcript_length=args.length,
        max_edge_clip=args.max_edge_clip,
        template_switch_filter=args.template_switch,
        write_uracil=args.uracil,
        header_prefix=args.prefix,
        no_reduce=args.norr and not args.mergepool,  # -mergepool overrides -norr
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
        revcomp_long=args.revcomp_long,
        lr_min_depth=args.lrrd,
        lr_overlap_prop=args.lrop,
        minimizer_size=args.minimizer,
        minimizer_window=args.minimizer_window,
        sketch_overlap_prop=args.sop,
        sketch_overlap_num=args.son,
        hpc=args.hpc,
        write_paf=args.paf,
        paf_in=args.pafin,
        verbose=True,
    )
    if args.mmopt:
        print("note: -mmopt ignored (internal overlapper replaces minimap2)", file=sys.stderr)
    if not args.nk and args.hist:
        params.expected_num_kmers = kselect.NTCardHistogram(args.hist).num_unique
    elif not args.nk and args.ntcard:
        # -ntcard: the internal distinct-k-mer sketch in place of the
        # external counter (RNABloom.java:5745-5767 execs `ntcard`)
        params.expected_num_kmers = kselect.estimate_num_unique_kmers(probe, k, device=device)
    if args.sensitive:
        # -sensitive (RNABloom.java:7033-7038): lower stringency
        params.min_num_kmer_pairs = max(1, args.pair // 2)
        params.min_overlap = max(5, args.overlap // 2)
    if args.pool:
        # as the JAX CLI, the pool run takes the default mate orientation
        reports = pipeline.assemble_pool(args.pool, args.outdir, params, device=device)
        if args.mergepool:
            pipeline.merge_pool(args.outdir, sorted(reports), params, device=device)
        return reports
    if args.long_reads:
        return pipeline.assemble_long(
            args.long_reads, args.outdir, params, subsample_spec=args.lrsub, force=args.force, device=device,
        )
    if args.left and args.right:
        return pipeline.assemble_pe(
            args.left, args.right, args.outdir, params,
            revcomp_left=args.revcomp_left, revcomp_right=args.revcomp_right,
            save_graph=args.savebf, force=args.force, device=device,
            sef_paths=args.sef or (), ser_paths=args.ser or (), ref_paths=args.ref or (),
        )
    paths = list(args.sef or []) + list(args.ser or [])
    flags = [False] * len(args.sef or []) + [True] * len(args.ser or [])
    return pipeline.assemble_se(paths, args.outdir, params, revcomp_flags=flags, device=device)


def main(argv=None) -> int:
    result = run(argv)
    if result is None:
        return 2
    if isinstance(result, dict):
        print(json.dumps({
            name: {"pairs": r.num_pairs, "fragments": r.num_fragments, "transcripts": r.num_transcripts}
            for name, r in result.items()
        }))
        return 0
    print(json.dumps({
        "pairs": result.num_pairs,
        "fragments": result.num_fragments,
        "transcripts": result.num_transcripts,
        "short": result.num_short,
        "nr": result.num_nr,
        "elapsed_s": round(result.elapsed_s, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

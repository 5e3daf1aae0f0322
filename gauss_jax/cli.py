"""Command-line interface.

Mirrors the reference R API's argument names (dist/distmix/computeLD/
simulateLD/afmix/cpw2/zmix/qcat/qcatmix/jepeg/jepegmix/fiqt) so users of
the reference can switch over directly::

    python -m gauss_jax distmix --chr 22 --start-bp 16000000 \
        --end-bp 17000000 --wing-size 500000 \
        --pop-wgt-file weights.tsv --input-file z.txt \
        --reference-index-file panel_index.gz \
        --reference-data-file panel_geno.gz \
        --reference-pop-desc-file pop_desc.txt -o out.tsv
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import pandas as pd


def _ref_args(p: argparse.ArgumentParser, window: bool = True,
              pop: str = "none"):
    if window:
        p.add_argument("--chr", type=int, required=True)
        p.add_argument("--start-bp", type=int, required=True)
        p.add_argument("--end-bp", type=int, required=True)
    p.add_argument("--input-file", required=True)
    p.add_argument("--reference-index-file", required=True)
    p.add_argument("--reference-data-file", required=True)
    p.add_argument("--reference-pop-desc-file", required=True)
    if pop == "study":
        p.add_argument("--study-pop", required=True)
    elif pop == "wgt":
        p.add_argument("--pop-wgt-file", required=True,
                       help="TSV/whitespace file with columns pop wgt "
                            "(afmix output format)")
    p.add_argument("-o", "--output", default="-",
                   help="output TSV path ('-' = stdout)")


def _parse_mesh(s):
    """'WxS' -> (window x subject) jax mesh, or None."""
    if not s:
        return None
    try:
        n_win, n_sub = (int(x) for x in s.lower().split("x"))
    except ValueError:
        raise SystemExit(f"ERROR: --mesh expects WxS (e.g. 2x4), got '{s}'")
    from gauss_jax.parallel.mesh import make_mesh
    return make_mesh(n_win, n_sub)


def _read_pop_wgt(path: str) -> pd.DataFrame:
    try:
        df = pd.read_csv(path, sep=r"\s+")
    except Exception as e:
        raise SystemExit(
            f"ERROR: cannot parse population-weight file '{path}' "
            f"(expected columns: pop wgt): {e}")
    cols = [c.lower() for c in df.columns]
    if "pop" in cols and "wgt" in cols:
        return df[[df.columns[cols.index("pop")],
                   df.columns[cols.index("wgt")]]]
    return df.iloc[:, :2]


def _emit(df: pd.DataFrame, out: str):
    if out == "-":
        df.to_csv(sys.stdout, sep="\t", index=False)
    else:
        df.to_csv(out, sep="\t", index=False)


def _emit_matrix(mat: np.ndarray, path: str):
    np.savetxt(path, mat, fmt="%.10g", delimiter="\t")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="gauss_jax",
        description="GWAS summary-statistics engine "
                    "(capabilities of statsleelab/gauss)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    for name, pop in [("dist", "study"), ("distmix", "wgt"),
                      ("qcat", "study"), ("qcatmix", "wgt")]:
        p = sub.add_parser(name)
        _ref_args(p, window=True, pop=pop)
        p.add_argument("--wing-size", type=int, required=True)
        p.add_argument("--af1-cutoff", type=float, default=None)

    p = sub.add_parser("computeLD", aliases=["compute-ld"])
    _ref_args(p, window=True, pop="wgt")
    p.add_argument("--af1-cutoff", type=float, default=None)
    p.add_argument("--cormat-out", default=None)

    p = sub.add_parser("simulateLD", aliases=["simulate-ld"])
    _ref_args(p, window=True, pop="wgt")
    p.add_argument("--sim-size", type=int, required=True)
    p.add_argument("--af1-cutoff", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--cormat-out", default=None)

    for name in ("afmix", "cpw2"):
        p = sub.add_parser(name)
        _ref_args(p, window=False)
        p.add_argument("--interval", type=int, default=None)
        p.add_argument("--panel-cache", default=None,
                       help="decoded panel cache dir (panel-cache cmd); "
                            "skips the bgzf decode")

    p = sub.add_parser("zmix")
    _ref_args(p, window=False)
    p.add_argument("--percentile", type=float, default=0.9)
    p.add_argument("--interval", type=int, default=10)
    p.add_argument("--level", choices=["population", "superpopulation"],
                   default="population")
    p.add_argument("--panel-cache", default=None,
                   help="decoded panel cache dir (panel-cache cmd); "
                        "skips the bgzf decode")
    p.add_argument("--mesh", default=None, metavar="WxS",
                   help="shard the pair correlations over a (window x "
                        "subject) device mesh, e.g. 2x4 (needs W*S "
                        "devices and --panel-cache)")

    for name, pop in [("jepeg", "study"), ("jepegmix", "wgt")]:
        p = sub.add_parser(name)
        _ref_args(p, window=False, pop=pop)
        p.add_argument("--annotation-file", required=True)
        p.add_argument("--af1-cutoff", type=float, default=None)

    # prep_* exports (reference: src/RcppExports.cpp:16-355) -- the raw
    # regression/imputation ingredients at the user level
    for name in ("prep-zmix", "prep-zmix2", "prep-zmix3", "prep-zmix4",
                 "prep-zmix5", "prep-zmix5-sup"):
        p = sub.add_parser(
            name, help="Z-based ancestry regression dataset (matrix TSV)")
        _ref_args(p, window=False)
        if name in ("prep-zmix5", "prep-zmix5-sup"):
            p.add_argument("--percentile", type=float, default=None)
        p.add_argument("--interval", type=int, default=None)
        if name in ("prep-zmix2", "prep-zmix4"):
            p.add_argument("--offset", type=int, default=None)
        if name == "prep-zmix3":
            p.add_argument("--steps", type=int, default=None)

    p = sub.add_parser("prep-qcat",
                       help="raw QCAT ingredients (snplist TSV + npz with "
                            "z_vec/cor_mat1/cor_mat2)")
    _ref_args(p, window=True, pop="study")
    p.add_argument("--wing-size", type=int, required=True)
    p.add_argument("--af1-cutoff", type=float, default=None)
    p.add_argument("--npz-out", required=True,
                   help="output .npz for z_vec, cor_mat1, cor_mat2")

    p = sub.add_parser("prep-recessive-impute",
                       help="imputation prep under add/dom/rec codings "
                            "(snplist TSV + npz with zvec + 4 cormats)")
    _ref_args(p, window=True, pop="wgt")
    p.add_argument("--wing-size", type=int, required=True)
    p.add_argument("--af1-cutoff", type=float, default=None)
    p.add_argument("--npz-out", required=True,
                   help="output .npz for zvec, cormat, cormat_add/dom/rec")

    p = sub.add_parser("fiqt")
    p.add_argument("--input-file", required=True,
                   help="text file with a z column (or single column)")
    p.add_argument("-o", "--output", default="-")

    p = sub.add_parser("panel-cache",
                       help="decode a bgzf panel to the columnar cache")
    p.add_argument("--reference-index-file", required=True)
    p.add_argument("--reference-data-file", required=True)
    p.add_argument("--reference-pop-desc-file", required=True)
    p.add_argument("--chr", type=int, default=0)
    p.add_argument("-o", "--output", required=True, help="cache directory")

    p = sub.add_parser("impute-region",
                       help="genome-scale windowed distmix over a cached "
                            "or bgzf panel")
    _ref_args(p, window=True, pop="wgt")
    p.add_argument("--window-bp", type=int, default=1_000_000)
    p.add_argument("--wing-size", type=int, default=500_000)
    p.add_argument("--af1-cutoff", type=float, default=0.01)
    p.add_argument("--panel-cache", default=None,
                   help="use a decoded panel cache dir instead of bgzf")
    p.add_argument("--device-linalg", action="store_true")
    p.add_argument("--mesh", default=None, metavar="WxS",
                   help="run sharded over a (window x subject) device "
                        "mesh, e.g. 2x4 (needs W*S devices); implies "
                        "--device-linalg")

    p = sub.add_parser("qcat-region",
                       help="genome-scale windowed qcatmix over a cached "
                            "or bgzf panel")
    _ref_args(p, window=True, pop="wgt")
    p.add_argument("--window-bp", type=int, default=1_000_000)
    p.add_argument("--wing-size", type=int, default=500_000)
    p.add_argument("--af1-cutoff", type=float, default=0.05)
    p.add_argument("--panel-cache", default=None)

    p = sub.add_parser("impute-genome",
                       help="checkpointed chunked analysis (distmix/dist/"
                            "qcat/jepeg/computeLD) over a whole "
                            "chromosome/region; resumable (--run-dir)")
    _ref_args(p, window=True, pop="none")
    p.add_argument("--pop-wgt-file", default=None,
                   help="TSV with columns pop wgt -> cosmopolitan "
                        "(distmix/qcatmix/jepegmix/computeLD) mode")
    p.add_argument("--study-pop", default=None,
                   help="population or super-population name -> "
                        "homogeneous (dist/qcat/jepeg) mode")
    p.add_argument("--annotation-file", default=None,
                   help="required for --analysis jepeg")
    p.add_argument("--window-bp", type=int, default=1_000_000)
    p.add_argument("--wing-size", type=int, default=500_000)
    p.add_argument("--chunk-bp", type=int, default=16_000_000)
    p.add_argument("--af1-cutoff", type=float, default=None,
                   help="default 0.01 (0.05 for --analysis qcat, "
                        "matching the reference qcat default)")
    p.add_argument("--panel-cache", default=None)
    p.add_argument("--run-dir", required=True,
                   help="checkpoint directory (manifest + result shards)")
    p.add_argument("--restart", action="store_true",
                   help="ignore completed chunks and recompute everything")
    p.add_argument("--host-linalg", action="store_true",
                   help="float64 host solves instead of the fused device "
                        "kernel")
    p.add_argument("--trace-log", default=None,
                   help="append phase timings to this JSONL file")
    p.add_argument("--status", action="store_true",
                   help="print the run's chunk ledger and exit")
    p.add_argument("--stream", action="store_true",
                   help="decode the panel per chunk instead of holding "
                        "the whole range in RAM (for panels larger than "
                        "host memory)")
    p.add_argument("--analysis",
                   choices=["impute", "qcat", "jepeg", "ld"],
                   default="impute",
                   help="which analysis to run per chunk (ld = "
                        "computeLD; dense matrices land in "
                        "run-dir/results/*_cormat.npz)")
    p.add_argument("--mesh", default=None, metavar="WxS",
                   help="run sharded over a (window x subject) device "
                        "mesh, e.g. 2x4 (needs W*S devices)")
    p.add_argument("--multihost", action="store_true",
                   help="stripe windows across jax.distributed processes "
                        "(JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/"
                        "JAX_PROCESS_ID); each host runs its own ledger "
                        "under run-dir/hostNNN, process 0 merges")

    args = ap.parse_args(argv)

    import gauss_jax

    ref = {}
    if hasattr(args, "reference_index_file"):
        ref = dict(
            reference_index_file=args.reference_index_file,
            reference_data_file=args.reference_data_file,
            reference_pop_desc_file=args.reference_pop_desc_file,
        )

    if args.cmd in ("dist", "qcat"):
        fn = getattr(gauss_jax, args.cmd)
        df = fn(args.chr, args.start_bp, args.end_bp, args.wing_size,
                args.study_pop, args.input_file, **ref,
                af1_cutoff=args.af1_cutoff)
        _emit(df, args.output)
    elif args.cmd in ("distmix", "qcatmix"):
        fn = getattr(gauss_jax, args.cmd)
        df = fn(args.chr, args.start_bp, args.end_bp, args.wing_size,
                _read_pop_wgt(args.pop_wgt_file), args.input_file, **ref,
                af1_cutoff=args.af1_cutoff)
        _emit(df, args.output)
    elif args.cmd in ("computeLD", "compute-ld"):
        res = gauss_jax.compute_ld(
            args.chr, args.start_bp, args.end_bp,
            _read_pop_wgt(args.pop_wgt_file), args.input_file, **ref,
            af1_cutoff=args.af1_cutoff)
        _emit(res["snplist"], args.output)
        if args.cormat_out:
            _emit_matrix(res["cormat"], args.cormat_out)
    elif args.cmd in ("simulateLD", "simulate-ld"):
        res = gauss_jax.simulate_ld(
            args.chr, args.start_bp, args.end_bp,
            _read_pop_wgt(args.pop_wgt_file), args.sim_size,
            args.input_file, **ref, af1_cutoff=args.af1_cutoff,
            seed=args.seed)
        _emit(res["snplist"], args.output)
        if args.cormat_out:
            _emit_matrix(res["cormat"], args.cormat_out)
    elif args.cmd in ("afmix", "cpw2"):
        if args.panel_cache:
            from gauss_jax.io import readers
            from gauss_jax.models import ancestry
            from gauss_jax.models.genome import PanelStore
            store = PanelStore.load(args.panel_cache)
            inp = readers.read_input_af(args.input_file)
            fn = (ancestry.afmix_store if args.cmd == "afmix"
                  else ancestry.cpw2_store)
            df = fn(store, inp, interval=args.interval)
        else:
            fn = getattr(gauss_jax, args.cmd)
            df = fn(args.input_file, **ref, interval=args.interval)
        _emit(df, args.output)
    elif args.cmd == "zmix":
        mesh = _parse_mesh(args.mesh)
        if mesh is not None and not args.panel_cache:
            raise SystemExit("ERROR: zmix --mesh requires --panel-cache")
        if args.panel_cache:
            from gauss_jax.io import readers
            from gauss_jax.models import ancestry
            from gauss_jax.models.genome import PanelStore
            store = PanelStore.load(args.panel_cache)
            inp = readers.read_input_z(args.input_file, all_snps=True)
            df = ancestry.zmix_store(store, inp,
                                     percentile=args.percentile,
                                     interval=args.interval,
                                     level=args.level, mesh=mesh)
        else:
            df = gauss_jax.zmix(args.input_file, **ref,
                                percentile=args.percentile,
                                interval=args.interval, level=args.level)
        _emit(df, args.output)
    elif args.cmd in ("jepeg", "jepegmix"):
        if args.cmd == "jepeg":
            df = gauss_jax.jepeg(args.study_pop, args.input_file,
                                 args.annotation_file, **ref,
                                 af1_cutoff=args.af1_cutoff)
        else:
            df = gauss_jax.jepegmix(_read_pop_wgt(args.pop_wgt_file),
                                    args.input_file, args.annotation_file,
                                    **ref, af1_cutoff=args.af1_cutoff)
        _emit(df, args.output)
    elif args.cmd.startswith("prep-zmix"):
        fn = getattr(gauss_jax, args.cmd.replace("-", "_"))
        kwargs = {"interval": args.interval}
        if args.cmd in ("prep-zmix5", "prep-zmix5-sup"):
            kwargs["percentile"] = args.percentile
        if args.cmd in ("prep-zmix2", "prep-zmix4"):
            kwargs["offset"] = args.offset
        if args.cmd == "prep-zmix3":
            kwargs["steps"] = args.steps
        mat = fn(args.input_file, **ref, **kwargs)
        if args.output == "-":
            np.savetxt(sys.stdout, mat, fmt="%.10g", delimiter="\t")
        else:
            _emit_matrix(mat, args.output)
    elif args.cmd == "prep-qcat":
        res = gauss_jax.prep_qcat(
            args.chr, args.start_bp, args.end_bp, args.wing_size,
            args.study_pop, args.input_file, **ref,
            af1_cutoff=args.af1_cutoff)
        _emit(res["snplist"], args.output)
        np.savez_compressed(args.npz_out, z_vec=res["z_vec"],
                            cor_mat1=res["cor_mat1"],
                            cor_mat2=res["cor_mat2"])
    elif args.cmd == "prep-recessive-impute":
        res = gauss_jax.prep_recessive_impute(
            args.chr, args.start_bp, args.end_bp, args.wing_size,
            _read_pop_wgt(args.pop_wgt_file), args.input_file, **ref,
            af1_cutoff=args.af1_cutoff)
        _emit(res["snplist"], args.output)
        np.savez_compressed(args.npz_out, zvec=res["zvec"],
                            cormat=res["cormat"],
                            cormat_add=res["cormat_add"],
                            cormat_dom=res["cormat_dom"],
                            cormat_rec=res["cormat_rec"])
    elif args.cmd == "fiqt":
        df = pd.read_csv(args.input_file, sep=r"\s+")
        zcol = "z" if "z" in df.columns else df.columns[-1]
        df["z_fiqt"] = gauss_jax.fiqt(df[zcol].to_numpy())
        _emit(df, args.output)
    elif args.cmd == "panel-cache":
        from gauss_jax.config import PanelFiles
        from gauss_jax.models.genome import PanelStore
        store = PanelStore.from_bgzf(
            PanelFiles(args.reference_index_file, args.reference_data_file,
                       args.reference_pop_desc_file), chrom=args.chr)
        store.save(args.output)
        print(f"cached {store.G.shape[0]} SNPs x {store.G.shape[1]} "
              f"subjects -> {args.output}", file=sys.stderr)
    elif args.cmd == "impute-region":
        from gauss_jax.config import PanelFiles
        from gauss_jax.io import readers
        from gauss_jax.models.genome import GenomeEngine, PanelStore
        if args.panel_cache:
            store = PanelStore.load(args.panel_cache)
        else:
            store = PanelStore.from_bgzf(
                PanelFiles(args.reference_index_file,
                           args.reference_data_file,
                           args.reference_pop_desc_file), chrom=args.chr)
        inp = readers.read_input_z(args.input_file, chrom=args.chr,
                                   start_bp=args.start_bp,
                                   end_bp=args.end_bp,
                                   wing_size=args.wing_size)
        eng = GenomeEngine(store, device_linalg=args.device_linalg,
                           mesh=_parse_mesh(args.mesh))
        run = eng.prepare_mix(
            inp, readers.pop_wgt_map_from_df(_read_pop_wgt(args.pop_wgt_file)),
            af1_cutoff=args.af1_cutoff)
        df = run.impute_region(args.start_bp, args.end_bp,
                               window_bp=args.window_bp,
                               wing_size=args.wing_size)
        _emit(df, args.output)
    elif args.cmd == "qcat-region":
        from gauss_jax.config import PanelFiles
        from gauss_jax.io import readers
        from gauss_jax.models.genome import GenomeEngine, PanelStore
        if args.panel_cache:
            store = PanelStore.load(args.panel_cache)
        else:
            store = PanelStore.from_bgzf(
                PanelFiles(args.reference_index_file,
                           args.reference_data_file,
                           args.reference_pop_desc_file), chrom=args.chr)
        inp = readers.read_input_z(args.input_file, chrom=args.chr,
                                   start_bp=args.start_bp,
                                   end_bp=args.end_bp,
                                   wing_size=args.wing_size)
        eng = GenomeEngine(store, device_linalg=True)
        run = eng.prepare_mix(
            inp, readers.pop_wgt_map_from_df(_read_pop_wgt(args.pop_wgt_file)),
            af1_cutoff=args.af1_cutoff)
        df = run.qcat_region(args.start_bp, args.end_bp,
                             window_bp=args.window_bp,
                             wing_size=args.wing_size)
        _emit(df, args.output)
    elif args.cmd == "impute-genome":
        import os
        from gauss_jax.config import PanelFiles
        from gauss_jax.io import readers
        from gauss_jax.models.genome import GenomeEngine, PanelStore
        from gauss_jax.models.runner import GenomeRunner, MANIFEST
        from gauss_jax.utils.timing import Tracer
        if args.af1_cutoff is None:
            # reference qcat/qcatmix default 0.05 (src/qcat.cpp:52-56);
            # everything else 0.01
            args.af1_cutoff = 0.05 if args.analysis == "qcat" else 0.01
        if args.multihost:
            # must precede any backend initialization
            from gauss_jax.parallel import distributed
            distributed.initialize()
        if args.status:
            # read-only: never decode the panel or rewrite the manifest
            mpath = os.path.join(args.run_dir, MANIFEST)
            if not os.path.exists(mpath):
                raise SystemExit(f"ERROR: no manifest at {mpath}")
            with open(mpath) as fh:
                data = json.load(fh)
            counts = {"pending": 0, "done": 0, "failed": 0}
            for c in data.get("chunks", []):
                counts[c["status"]] = counts.get(c["status"], 0) + 1
            print(json.dumps(counts))
            for c in data.get("chunks", []):
                line = (f"{c['chrom']}_{c['start_bp']}_{c['end_bp']}\t"
                        f"{c['status']}\t{c['n_rows']} rows")
                if c.get("error"):
                    line += "\t" + c["error"].splitlines()[0]
                print(line, file=sys.stderr)
            return
        pf = PanelFiles(args.reference_index_file,
                        args.reference_data_file,
                        args.reference_pop_desc_file)
        panel_files = None
        if args.stream:
            store = None              # decoded chunk-by-chunk
            panel_files = pf
        elif args.panel_cache:
            store = PanelStore.load(args.panel_cache)
        else:
            store = PanelStore.from_bgzf(pf, chrom=args.chr)
        inp = readers.read_input_z(args.input_file, chrom=args.chr,
                                   start_bp=args.start_bp,
                                   end_bp=args.end_bp,
                                   wing_size=args.wing_size)
        eng = GenomeEngine(store, device_linalg=not args.host_linalg,
                           mesh=_parse_mesh(args.mesh))
        if (args.pop_wgt_file is None) == (args.study_pop is None):
            raise SystemExit("ERROR: exactly one of --pop-wgt-file / "
                             "--study-pop required")
        pop_wgt = (readers.pop_wgt_map_from_df(
                       _read_pop_wgt(args.pop_wgt_file))
                   if args.pop_wgt_file else None)
        annot_df = None
        if args.analysis == "jepeg":
            if not args.annotation_file:
                raise SystemExit("ERROR: --analysis jepeg needs "
                                 "--annotation-file")
            annot_df = readers.read_annotation(args.annotation_file)
        def _make_runner(run_dir, lo=None, hi=None):
            return GenomeRunner(
                run_dir, eng, inp, pop_wgt,
                af1_cutoff=args.af1_cutoff, window_bp=args.window_bp,
                wing_size=args.wing_size, chunk_bp=args.chunk_bp,
                tracer=Tracer(verbose=True, log_file=args.trace_log),
                panel_files=panel_files, analysis=args.analysis,
                study_pop=args.study_pop, annot_df=annot_df)
        if args.multihost:
            from gauss_jax.parallel import distributed
            df = distributed.run_genome_multihost(
                _make_runner, args.chr, args.start_bp, args.end_bp,
                args.window_bp, args.run_dir)
            if df is not None:
                _emit(df, args.output)
            return
        runner = _make_runner(args.run_dir)
        runner.plan(args.chr, args.start_bp, args.end_bp)
        stats = runner.run(resume=not args.restart)
        print(f"[gauss_jax] chunks done={stats['done']} "
              f"failed={stats['failed']} skipped={stats['skipped']}",
              file=sys.stderr)
        if stats["failed"]:
            first = next(c for c in runner.chunks.values()
                         if c.status == "failed")
            print(f"[gauss_jax] first failure ({first.key}): "
                  f"{(first.error or '').splitlines()[0]}", file=sys.stderr)
        if stats["done"] + stats["skipped"] == 0:
            # a genome run where EVERY chunk failed must not silently
            # emit an empty file and exit 0 (reference analog: fail-fast
            # Rcpp::stop, /root/reference/src/dist.cpp:145-151)
            raise SystemExit(
                "ERROR: every chunk failed; no output written "
                f"(see {args.run_dir}/manifest.json for per-chunk errors)")
        _emit(runner.collect(), args.output)


if __name__ == "__main__":
    main()

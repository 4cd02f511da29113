"""Command-line interface (port of sfm_tpu/cli.py): per-stage and end to end.

    python -m sfm_tpu_torch.cli reconstruct IMAGES_DIR --out OUT_DIR [--device cpu] [key=value...]
    python -m sfm_tpu_torch.cli features IMAGES_DIR --out OUT_DIR [--device cpu]
    python -m sfm_tpu_torch.cli match IMAGES_DIR --out OUT_DIR [--device cpu]
    python -m sfm_tpu_torch.cli export ARTIFACT_DIR --out OUT_DIR [--binary] [--ply]
    python -m sfm_tpu_torch.cli info ARTIFACT_DIR

Config overrides use dotted paths: sift.max_keypoints=8192 ba.max_iterations=100;
values are parsed as JSON (pair_mode='"vocab_tree"'), else kept as strings.
--device (default cuda) is the device of the device stages; cuda without a
visible GPU raises. OUT_DIR holds the stage artifacts (resumed by a rerun),
stage_timings.json, and after reconstruct the COLMAP model in sparse/ (text
and binary) and cloud.ply.

On N GPUs of one host, one process per GPU:

    torchrun --nproc_per_node=N -m sfm_tpu_torch.cli reconstruct IMAGES_DIR --out OUT_DIR \
        shard.num_devices=N shard.multihost=true

--device cuda is then cuda:LOCAL_RANK; every process runs the pipeline and
prints the summary, and the process of local rank 0 writes OUT_DIR.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _parse_overrides(items):
    out = {}
    for it in items:
        if "=" not in it:
            raise SystemExit(f"override must be key=value: {it}")
        k, v = it.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass  # keep string
        out[k] = v
    return out


def parse_args(argv=None):
    """(parsed arguments, overrides dict). Overrides may come before or
    after the options: argparse hands a trailing nargs="*" positional the
    tokens of one run only, and which run differs between Python releases,
    so key=value tokens it leaves over are collected here."""
    p = argparse.ArgumentParser(prog="sfm_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_common(sp):
        sp.add_argument("images", help="image directory")
        sp.add_argument("--out", required=True, help="artifact/output directory")
        sp.add_argument("--device", default="cuda", help="torch device of the device stages")
        sp.add_argument("overrides", nargs="*", help="config overrides key=value")

    add_common(sub.add_parser("reconstruct", help="full pipeline"))
    add_common(sub.add_parser("features", help="feature extraction only"))
    add_common(sub.add_parser("match", help="features + matching/verification"))

    ep = sub.add_parser("export", help="export artifacts to COLMAP text/binary + PLY")
    ep.add_argument("artifacts", help="artifact directory of a completed run")
    ep.add_argument("--out", required=True)
    ep.add_argument("--ply", action="store_true")
    ep.add_argument("--binary", action="store_true",
                    help="also write cameras.bin/images.bin/points3D.bin")

    ip = sub.add_parser("info", help="print reconstruction summary")
    ip.add_argument("artifacts")

    args, rest = p.parse_known_args(argv)
    if rest and (not hasattr(args, "overrides") or any(r.startswith("-") for r in rest)):
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    return args, _parse_overrides(getattr(args, "overrides", []) + rest)


def main(argv=None):
    args, ov = parse_args(argv)

    if args.cmd in ("reconstruct", "features", "match"):
        from sfm_tpu_torch.api import resolve_device
        from sfm_tpu_torch.config import PipelineConfig, apply_overrides

        device = resolve_device(args.device)
        cfg = PipelineConfig(artifact_dir=args.out)
        if ov:
            cfg = apply_overrides(cfg, ov)

        if args.cmd == "reconstruct":
            from sfm_tpu_torch.dist.mesh import mesh_for
            from sfm_tpu_torch.pipeline.run import is_writer, run_pipeline
            from sfm_tpu_torch.scene.export import write_colmap_bin, write_colmap_text, write_ply

            rec = run_pipeline(args.images, cfg, device)
            if is_writer(mesh_for(cfg.shard, device)):
                write_colmap_text(rec, os.path.join(args.out, "sparse"))
                write_colmap_bin(rec, os.path.join(args.out, "sparse"))
                write_ply(rec, os.path.join(args.out, "cloud.ply"))
            print(json.dumps(rec.summary()))
        else:
            # Stage-only runs: just the needed stages through the artifact store.
            from sfm_tpu_torch.config import config_hash
            from sfm_tpu_torch.dist.mesh import initialize_multihost, mesh_for
            from sfm_tpu_torch.pipeline import ingest as ing, stages as st
            from sfm_tpu_torch.pipeline.run import is_writer
            from sfm_tpu_torch.scene.artifacts import ArtifactStore, input_hash

            if cfg.shard.multihost:
                initialize_multihost(cfg.shard, device)
            mesh = mesh_for(cfg.shard, device)
            batch = ing.load_images(args.images, cfg.sift)
            store = ArtifactStore(args.out, writable=is_writer(mesh))
            key = config_hash(cfg) + "-" + input_hash(batch.canvases, batch.names)
            if store.is_complete("features", key):
                feats = store.load_features()
            else:
                feats = st.extract_stage(batch, cfg, device, mesh)
                store.save_features(key, feats)
            print(f"features: {feats.valid.sum(1).tolist()}")
            if args.cmd == "match":
                pairs = st.exhaustive_pairs(len(batch.canvases))
                if store.is_complete("matches", key):
                    graph = store.load_graph()
                else:
                    graph = st.match_and_verify_stage(feats, pairs, batch.intrinsics, cfg, device,
                                                      seed=cfg.seed, mesh=mesh)
                    store.save_graph(key, graph)
                print(f"verified edges: {int(graph.ok.sum())}/{len(graph.pairs)}")
        return 0

    if args.cmd == "export":
        from sfm_tpu_torch.scene.artifacts import ArtifactStore
        from sfm_tpu_torch.scene.export import write_colmap_bin, write_colmap_text, write_ply

        store = ArtifactStore(args.artifacts)
        rec = store.load_reconstruction()
        write_colmap_text(rec, os.path.join(args.out, "sparse"))
        if args.binary:
            write_colmap_bin(rec, os.path.join(args.out, "sparse"))
        if args.ply:
            write_ply(rec, os.path.join(args.out, "cloud.ply"))
        print(f"exported to {args.out}")
        return 0

    if args.cmd == "info":
        from sfm_tpu_torch.scene.artifacts import ArtifactStore

        store = ArtifactStore(args.artifacts)
        rec = store.load_reconstruction()
        print(json.dumps(rec.summary(), indent=2))
        return 0


if __name__ == "__main__":
    sys.exit(main())

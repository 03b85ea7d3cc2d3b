"""Command-line interface of the port (port of ``hashgan_tpu/cli.py``).

  python -m hashgan_tpu_torch train --config config2 [--stage 1|2|all]
      [--iters N]
  python -m hashgan_tpu_torch eval --config config1 [--workdir DIR]
  python -m hashgan_tpu_torch encode --config config1 --split query --out codes.npz
  python -m hashgan_tpu_torch build-index --config config1 --out gallery.npz
  python -m hashgan_tpu_torch query --gallery gallery.npz --k 10
  python -m hashgan_tpu_torch serve --gallery gallery.npz [--config config1]
  python -m hashgan_tpu_torch bench-scan [--bits 128 --n 1000000 --q 1024]
  python -m hashgan_tpu_torch bench-serve [--bits 48 --n 1000000 --batch 256
      --k 100]

``train --stage 1`` trains the GAN (where the config has one), ``--stage
2`` the encoder, ``--stage all`` both in turn. ``--config`` takes a preset
name or a path to a yaml override file. ``train``, ``eval``, ``encode`` and
``build-index`` run on the config's mesh (``make_mesh(cfg.mesh.n_devices,
cfg.mesh.data_axis)``, ``n_devices`` 0 meaning every CUDA device), as the
reference's do, unless ``--gpu i`` names one card, which they then run on
alone. ``query``, ``serve``, ``bench-scan`` and ``bench-serve`` run on CUDA
device ``--gpu`` (default 0). Every command fails without CUDA. Galleries
are the reference's npz artifacts (either package reads the other's).
``serve --config`` restores the encoder checkpoint of ``--workdir``
(default ``cfg.train.workdir``) and answers image queries as well as code
queries.
``bench-scan`` and ``bench-serve`` print ``bench_scan.run_bench`` and
``bench_serve.run_serving_bench`` as one JSON line each.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _device(gpu: int):
    from hashgan_tpu_torch.utils.device import require_cuda, set_numerics

    set_numerics()
    return require_cuda(gpu)


def _load_config(spec: str):
    from hashgan_tpu_torch.configs import get_config, load_yaml

    if os.path.exists(spec):
        return load_yaml(spec)
    return get_config(spec)


def _mesh(cfg, gpu):
    """The mesh of an experiment command: the config's without ``--gpu``,
    the one card ``--gpu`` names with it."""
    from hashgan_tpu_torch.parallel.mesh import Mesh, make_mesh
    from hashgan_tpu_torch.utils.device import set_numerics

    if gpu is not None:
        return Mesh([_device(gpu)], cfg.mesh.data_axis)
    set_numerics()
    return make_mesh(cfg.mesh.n_devices, cfg.mesh.data_axis)


def _experiment(args):
    from hashgan_tpu_torch.train.loop import Experiment

    cfg = _load_config(args.config)
    return Experiment(cfg, workdir=args.workdir, mesh=_mesh(cfg, args.gpu))


def cmd_train(args) -> None:
    exp = _experiment(args)
    cfg = exp.cfg
    if args.resume:
        exp.restore_checkpoint()
    elif args.stage == "2" and cfg.use_gan:
        # stage 2 continues from stage 1's checkpoint, as in the reference
        # (train_encoder also warns and trains on real images when no
        # checkpoint holds a trained generator)
        if exp.restore_checkpoint():
            print("restored stage-1 checkpoint from workdir", file=sys.stderr)
    if args.stage in ("1", "all") and cfg.use_gan:
        exp.train_gan(args.iters)
    if args.stage in ("2", "all"):
        exp.train_encoder(args.iters)
        print(json.dumps(exp.evaluate()))


def cmd_eval(args) -> None:
    exp = _experiment(args)
    if not exp.restore_checkpoint():
        print("warning: no checkpoint found; evaluating random init",
              file=sys.stderr)
    print(json.dumps(exp.evaluate()))


def cmd_encode(args) -> None:
    """A split's continuous and packed codes to an npz (the reference's
    code dumps)."""
    from hashgan_tpu_torch.ops.pack import pack_codes

    exp = _experiment(args)
    exp.restore_checkpoint()
    codes = exp.encode_split(args.split)
    packed = pack_codes(codes).cpu().numpy().view(np.uint32)
    codes = codes.cpu().numpy()
    np.savez(args.out, codes=codes, packed=packed,
             labels=exp.splits[args.split].labels, bits=exp.cfg.encoder.bits)
    print(json.dumps({"split": args.split, "n": len(codes), "path": args.out}))


def cmd_build_index(args) -> None:
    exp = _experiment(args)
    exp.restore_checkpoint()
    gal = exp.build_index(save_path=args.out)
    print(json.dumps({"items": gal.n, "bits": gal.bits, "path": args.out}))


def cmd_query(args) -> None:
    from hashgan_tpu_torch.index import PackedGallery, QueryEngine

    gal = PackedGallery.load(args.gallery, device=_device(args.gpu))
    if args.codes:
        codes = np.load(args.codes)
    else:  # demo: random probes
        codes = np.random.default_rng(0).standard_normal(
            (args.n_queries, gal.bits))
    res = QueryEngine(None, gal).query_codes(codes, k=args.k)
    for qi in range(min(len(codes), 8)):
        print(json.dumps({
            "query": qi,
            "neighbors": res.indices[qi].tolist(),
            "distances": res.distances[qi].tolist(),
        }))


def _serving_engine(args):
    from hashgan_tpu_torch.index import PackedGallery, QueryEngine

    device = _device(args.gpu)
    if args.config:
        cfg = _load_config(args.config)
        return QueryEngine.from_artifacts(
            cfg, args.workdir or cfg.train.workdir, args.gallery,
            device=device)
    return QueryEngine(None, PackedGallery.load(args.gallery, device=device))


def cmd_serve(args) -> None:
    from hashgan_tpu_torch.index.server import serve_forever

    serve_forever(_serving_engine(args), host=args.host, port=args.port,
                  default_k=args.k)


def cmd_bench_scan(args) -> None:
    from hashgan_tpu_torch.bench_scan import run_bench

    print(json.dumps(run_bench(bits=args.bits, n=args.n, q=args.q,
                               device=_device(args.gpu))))


def cmd_bench_serve(args) -> None:
    from hashgan_tpu_torch.bench_serve import run_serving_bench

    print(json.dumps(run_serving_bench(bits=args.bits, n=args.n,
                                       batch=args.batch, k=args.k,
                                       device=_device(args.gpu))))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="hashgan_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def with_gpu(parser, what, default=0):
        parser.add_argument("--gpu", type=int, default=default,
                            help=f"index of the CUDA device that {what}")
        return parser

    def with_config(parser):
        parser.add_argument("--config", required=True,
                            help="preset name or yaml override file")
        parser.add_argument("--workdir", default=None)
        return with_gpu(parser, "runs the experiment alone (default: the "
                                "config's mesh)", default=None)

    t = with_config(sub.add_parser("train", help="train the GAN (stage 1) "
                                                 "and the encoder (stage 2)"))
    t.add_argument("--stage", choices=("1", "2", "all"), default="all")
    t.add_argument("--iters", type=int, default=None)
    t.add_argument("--resume", action="store_true")
    t.set_defaults(fn=cmd_train)

    e = with_config(sub.add_parser("eval", help="Hamming-ranking evaluation"))
    e.set_defaults(fn=cmd_eval)

    n = with_config(sub.add_parser("encode", help="dump a split's codes"))
    n.add_argument("--split", choices=("train", "query", "database"),
                   default="query")
    n.add_argument("--out", required=True)
    n.set_defaults(fn=cmd_encode)

    b = with_config(sub.add_parser("build-index",
                                   help="encode database -> packed gallery"))
    b.add_argument("--out", required=True)
    b.set_defaults(fn=cmd_build_index)

    q = with_gpu(sub.add_parser("query", help="top-k scan against a saved "
                                              "gallery"), "holds the gallery")
    q.add_argument("--gallery", required=True)
    q.add_argument("--codes", default=None, help=".npy of query codes")
    q.add_argument("--k", type=int, default=10)
    q.add_argument("--n-queries", type=int, default=4)
    q.set_defaults(fn=cmd_query)

    w = with_gpu(sub.add_parser("serve", help="HTTP retrieval service over "
                                              "a gallery"), "holds the gallery")
    w.add_argument("--gallery", required=True)
    w.add_argument("--config", default=None,
                   help="preset/yaml: restore the encoder for image queries")
    w.add_argument("--workdir", default=None)
    w.add_argument("--host", default="127.0.0.1")
    w.add_argument("--port", type=int, default=8080)
    w.add_argument("--k", type=int, default=100)
    w.set_defaults(fn=cmd_serve)

    s = with_gpu(sub.add_parser("bench-scan", help="Hamming scan "
                                                   "throughput benchmark"),
                 "runs the benchmark")
    s.add_argument("--bits", type=int, default=128)
    s.add_argument("--n", type=int, default=1_000_000)
    s.add_argument("--q", type=int, default=1024)
    s.set_defaults(fn=cmd_bench_scan)

    v = with_gpu(sub.add_parser("bench-serve", help="end-to-end serving "
                                                    "benchmark (images -> "
                                                    "neighbours)"),
                 "runs the benchmark")
    v.add_argument("--bits", type=int, default=48)
    v.add_argument("--n", type=int, default=1_000_000)
    v.add_argument("--batch", type=int, default=256)
    v.add_argument("--k", type=int, default=100)
    v.set_defaults(fn=cmd_bench_serve)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

"""Command-line interface of the port (``query`` and ``serve``).

  python -m hashgan_tpu_torch query --gallery gallery.npz --k 10
  python -m hashgan_tpu_torch serve --gallery gallery.npz --port 8080

Galleries are the reference's npz artifacts (``hashgan_tpu build-index``
writes them; either package reads the other's). Both commands answer code
queries; image queries from the command line need an encoder checkpoint,
which comes with the training slice (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _device(gpu: int):
    from hashgan_tpu_torch.utils.device import require_cuda, set_numerics

    set_numerics()
    return require_cuda(gpu)


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


def cmd_serve(args) -> None:
    from hashgan_tpu_torch.index import PackedGallery, QueryEngine
    from hashgan_tpu_torch.index.server import serve_forever

    gal = PackedGallery.load(args.gallery, device=_device(args.gpu))
    serve_forever(QueryEngine(None, gal), host=args.host, port=args.port,
                  default_k=args.k)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="hashgan_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("query", help="top-k scan against a saved gallery")
    q.add_argument("--gallery", required=True)
    q.add_argument("--codes", default=None, help=".npy of query codes")
    q.add_argument("--k", type=int, default=10)
    q.add_argument("--n-queries", type=int, default=4)
    q.add_argument("--gpu", type=int, default=0,
                   help="index of the CUDA device that holds the gallery")
    q.set_defaults(fn=cmd_query)

    w = sub.add_parser("serve", help="HTTP retrieval service over a gallery")
    w.add_argument("--gallery", required=True)
    w.add_argument("--host", default="127.0.0.1")
    w.add_argument("--port", type=int, default=8080)
    w.add_argument("--k", type=int, default=100)
    w.add_argument("--gpu", type=int, default=0,
                   help="index of the CUDA device that holds the gallery")
    w.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

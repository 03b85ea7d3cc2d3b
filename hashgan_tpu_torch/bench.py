"""Benchmark entry point of the port (counterpart of the repository's
``bench.py``): prints ONE JSON line.

    python -m hashgan_tpu_torch.bench

Runs ``bench_scan.run_bench`` (1,024 queries x a 1,048,576-item 128-bit
packed gallery, exact top-100) on the first CUDA device and prints the
headline (``metric``, ``value``, ``unit``, ``vs_baseline``, ``verified``,
``tf_per_sec``, ``mfu``) the moment it is witnessed; the detail, which names
the card and its power limit, goes to stderr. Fails without a GPU.
"""

import json
import sys


def main() -> None:
    from hashgan_tpu_torch.bench_scan import run_bench
    from hashgan_tpu_torch.utils.device import require_cuda

    device = require_cuda()

    def on_headline(out):
        print(json.dumps(out), flush=True)

    result = run_bench(bits=128, n=1 << 20, q=1024, k=100,
                       headline_cb=on_headline, device=device)
    print(json.dumps(result["detail"]), file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()

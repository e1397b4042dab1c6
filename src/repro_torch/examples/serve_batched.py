"""Batched serving of a small model: batched decode over a synthetic
request queue with latency percentiles.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched --arch qwen3-4b
"""
import argparse

from repro_torch.launch.serve import serve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU")
    args = ap.parse_args()
    res = serve(args.arch, args.requests, args.batch, prompt_len=16,
                max_new=args.max_new, reduced=True, device=args.device)
    print(f"[serve] {res['requests']} requests, {res['tokens']} tokens, "
          f"{res['tokens_per_s']:.1f} tok/s, "
          f"p50 {res['latency_ms_p50']:.0f}ms "
          f"p99 {res['latency_ms_p99']:.0f}ms")


if __name__ == "__main__":
    main()

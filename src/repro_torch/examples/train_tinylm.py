"""End-to-end training driver: train a small LM for a few hundred steps
with checkpointing + restart; scale knobs reach ~100M params.

    PYTHONPATH=src python -m repro_torch.examples.train_tinylm --steps 300
    # ~100M-param config:
    PYTHONPATH=src python -m repro_torch.examples.train_tinylm \\
        --d-model 768 --layers 12 --vocab 32000 --steps 300

It runs on the GPU unless ``--device`` names another device.
"""
import argparse
import os
import tempfile

from repro_torch import configs as C
from repro_torch.launch.train import train
from repro_torch.models.config import ArchConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "tinylm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU")
    args = ap.parse_args()

    cfg = ArchConfig(
        name="tinylm", family="dense",
        n_layers=args.layers, d_model=args.d_model,
        n_heads=max(2, args.d_model // 64),
        n_kv_heads=max(2, args.d_model // 64),
        d_ff=args.d_model * 4, vocab=args.vocab,
        remat=False, dtype="float32")
    print(f"[tinylm] params ~ {cfg.param_count()/1e6:.1f}M")

    # route through the production training driver with a custom config
    C._MODULES["tinylm"] = None
    orig_get = C.get
    C.get = lambda n: cfg if n == "tinylm" else orig_get(n)
    try:
        res = train("tinylm", steps=args.steps, batch=args.batch,
                    seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                    reduced=False, base_lr=3e-3, device=args.device)
    finally:
        C.get = orig_get
    print(f"[tinylm] loss {res['first_loss']:.3f} -> {res['final_loss']:.3f} "
          f"over {args.steps} steps")
    assert res['final_loss'] < res['first_loss'], "loss must decrease"


if __name__ == "__main__":
    main()

"""Command line of the port: ``python -m papc_tpu_torch ...``.

Mirrors the JAX package's ``train.py``: it trains unless ``--evaluate``
is given, with the same flags, plus an explicit ``--device``. It serves
and trains ``pointnet2_ssg`` and ``pointnet2_msg`` in ``--mode clas``
(accuracy) and ``--mode seg`` (part segmentation, mean IoU). Training
writes flax variables as flat ``.npz`` files
(``{model_dir}/{name}_{epoch}.npz``, see :mod:`papc_tpu_torch.convert`);
``--evaluate --weights`` serves such a file in place of ``--checkpoint``.
``--precision bf16`` and ``--scan_steps`` above 1 are not ported yet and
exit with an error.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="papc_tpu_torch")
    parser.add_argument("--model_name", type=str, default="pointnet2_ssg")
    parser.add_argument("--mode", type=str, default="clas",
                        help='"clas" or "seg" (part segmentation)')
    parser.add_argument("--max_point", type=int, default=1024)
    parser.add_argument("--num_classes", type=int, default=16)
    parser.add_argument("--num_parts", type=int, default=50)
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--weight_decay", type=float, default=0.001)
    parser.add_argument("--epoch_num", type=int, default=10)
    parser.add_argument("--batchsize", type=int, default=32)
    parser.add_argument("--info_iter", type=int, default=40,
                        help="log every info_iter batches")
    parser.add_argument("--save_iter", type=int, default=2,
                        help="write weights every save_iter epochs")
    parser.add_argument("--path", type=str, default="./dataset/",
                        help="directory of the ShapeNet .h5 shards")
    parser.add_argument("--model_dir", type=str, default="./model/")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--precision", type=str, default="fp32",
                        choices=("fp32", "bf16"))
    parser.add_argument("--scan_steps", type=int, default=1)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--evaluate", action="store_true",
                        help="evaluate --weights on --split")
    parser.add_argument("--weights", type=str, default=None,
                        help="flax variables as a flat .npz")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.evaluate:
        if args.weights is None:
            parser.error("--evaluate needs --weights")
        from papc_tpu_torch.train import evaluate

        evaluate(args.model_name, args.mode, args.max_point,
                 args.num_classes, args.num_parts, args.batchsize, args.path,
                 weights=args.weights, split=args.split, device=args.device)
        return 0
    if args.precision != "fp32":
        parser.error("--precision bf16 is not ported yet (ROADMAP.md, "
                     "Queue 1 item 4: precision and checkpoints)")
    if args.scan_steps != 1:
        parser.error("--scan_steps > 1 is not ported (ROADMAP.md, Queue 1 "
                     "item 4: a CUDA-graph counterpart is an open question)")
    from papc_tpu_torch.train import train

    train(args.model_name, args.mode, args.max_point, args.num_classes,
          args.num_parts, args.learning_rate, args.weight_decay,
          args.epoch_num, args.batchsize, args.info_iter, args.save_iter,
          args.path, args.model_dir, args.seed, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

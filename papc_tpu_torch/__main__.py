"""Command line of the port: ``python -m papc_tpu_torch --evaluate ...``.

Mirrors the evaluate flags of the JAX package's ``train.py``, with
``--weights`` (flax variables as a flat ``.npz``, see
:mod:`papc_tpu_torch.convert`) in place of ``--checkpoint`` and an
explicit ``--device``. Training is not ported yet.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="papc_tpu_torch")
    parser.add_argument("--model_name", type=str, default="pointnet2_ssg")
    parser.add_argument("--mode", type=str, default="clas",
                        help='"clas" (the port serves classification)')
    parser.add_argument("--max_point", type=int, default=1024)
    parser.add_argument("--num_classes", type=int, default=16)
    parser.add_argument("--num_parts", type=int, default=50)
    parser.add_argument("--batchsize", type=int, default=32)
    parser.add_argument("--path", type=str, default="./dataset/",
                        help="directory of the ShapeNet .h5 shards")
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--evaluate", action="store_true",
                        help="evaluate --weights on --split")
    parser.add_argument("--weights", type=str, default=None,
                        help="flax variables as a flat .npz")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if not args.evaluate:
        parser.error("training is not ported yet (ROADMAP.md); "
                     "pass --evaluate")
    if args.weights is None:
        parser.error("--evaluate needs --weights")

    from papc_tpu_torch.train import evaluate

    evaluate(args.model_name, args.mode, args.max_point, args.num_classes,
             args.num_parts, args.batchsize, args.path,
             weights=args.weights, split=args.split, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

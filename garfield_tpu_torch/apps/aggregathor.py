"""AggregaThor: one trusted server, n workers, f Byzantine (the port's CLI;
counterpart of ``garfield_tpu/apps/aggregathor.py``).

    python -m garfield_tpu_torch.apps.aggregathor --dataset cifar10 \\
        --model resnet18 --batch 25 --num_workers 8 --fw 2 --gar median \\
        --attack lie --optimizer sgd \\
        --opt_args '{"lr":"0.2","momentum":"0.9","weight_decay":"0.0005"}' \\
        --num_iter 100

It takes the JAX CLI's flags and runs on the GPU (``--device cpu`` for the
plain PyTorch path); flags of features not ported yet raise.
"""

import sys

from ..parallel import aggregathor
from . import common

_CLUSTER = "ROADMAP Queue A item 11 (roles with device work)"


def parse_args(argv=None):
    """Parse the CLI, rejecting flags of features the port does not have."""
    parser = common.base_parser(
        "AggregaThor implementation using garfield_tpu_torch"
    )
    parser.add_argument("--cluster", type=str, default=None)
    parser.add_argument("--task", type=str, default=None)
    parser.add_argument("--cluster_timeout_ms", type=int, default=60_000)
    args = parser.parse_args(argv)
    common.reject_unported(parser, args, {
        "cluster": _CLUSTER, "task": _CLUSTER, "cluster_timeout_ms": _CLUSTER,
        **common.UNPORTED_FLAGS,
    })
    if not args.fw * 2 < args.num_workers:
        raise SystemExit(
            "the number of Byzantine workers should be less than half the "
            "number of workers"
        )
    return args


def main(argv=None):
    args = parse_args(argv)
    return common.train(
        args,
        topology=aggregathor,
        make_trainer_kwargs=dict(
            num_workers=args.num_workers, f=args.fw, attack=args.attack,
            attack_params=args.attack_params,
        ),
        num_slots=args.num_workers,
        tag="aggregathor",
    )


if __name__ == "__main__":
    main(sys.argv[1:])

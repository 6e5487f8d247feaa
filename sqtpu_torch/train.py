"""Training entry point of the port (counterpart of ``sqtpu/train.py``).

Usage::

    python -m sqtpu_torch.train [--model resnet_sq] [--loss implicit]
                                [--batch-size 32] [--max-epochs 100] ...
                                [--device cpu]

Every flag of ``python -m sqtpu.train`` is accepted (see
:class:`sqtpu_torch.utils.config.TrainConfig`); ``--device`` picks the card
(``cuda``, the default, an error when there is none) or the CPU.
"""

from __future__ import annotations

import sys

from sqtpu_torch.training.loop import train
from sqtpu_torch.utils.config import TrainConfig, parse_cli


def main(argv=None):
    return train(parse_cli(TrainConfig, argv))


if __name__ == "__main__":
    main(sys.argv[1:])

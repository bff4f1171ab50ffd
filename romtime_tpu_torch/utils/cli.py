"""Command-line helpers shared by the port's examples and diagnostic
scripts (``romtime_tpu_torch.examples``, ``romtime_tpu_torch.scripts``):
each runs on the card unless asked for the CPU, and nothing carries on
on the CPU when the card is missing."""

import torch


def add_device_argument(parser):
    """``--device`` (default ``cuda``; ``cpu`` asks for the host)."""
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; pass "
                             "cpu to run on the host)")
    return parser


def resolve_device(device="cuda"):
    """``device`` as a :class:`torch.device`; raises where it names the
    card and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this runs on the card unless "
                           "it is given --device cpu (device='cpu')")
    return device

"""Seeded serving artifacts: the benchmark's stand-in for a built fleet
or a built global ROM, drawn from ``--seed`` as a model benchmark draws
random weights, in the payload form the port loads (``convert`` of
``romtime_tpu_torch``: a flat dict of numpy arrays).

The recipe is the reference tests' stable one (the port's
``testing/synthetic.py``): per θ source ``k`` DEIM dofs away from the
ends of the mesh (a matrix dof's column within one of its row, the first
on the diagonal); per cell of W windows at N modes, combine tensors whose
columns are scaled by 1/max_t |θ_k(μ_center, t)| (here from the
benchmark's own frozen assembly), the mass combine carrying I and the
stiffness combine 2·I on their first dof and small noise elsewhere (so
bdf·M + dt·S stays diagonally dominant, the pivot-free regime), random
basis end rows (the probes), orthogonal window transfers, a trilinear
table of 0.02·noise, and on each registered cell a guarded dilation law
in a0. Every random number comes from one ``torch.Generator`` on the
device, in a few large calls, then moves to the host once.
"""

import numpy as np
import torch

from ..reference import assembly
from ..reference.mach import band_edges


def stream_seed(seed, *stream):
    """A 64-bit seed for one named stream of a run's ``--seed`` (and, for
    a per-call stream, the call's index)."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), *stream])
    return int(ss.generate_state(1, np.uint64)[0])


ARTIFACT_STREAM = 1


def time_grid(fom, dtype=torch.float64, device="cpu"):
    """(nt,) step end times (k+1)·dt."""
    nt, tf = int(fom["nt"]), float(fom["tf"])
    return (torch.arange(nt, dtype=dtype, device=device) + 1) * (tf / nt)


def theta_scales(config, dofs, device):
    """Per source, max over the time grid of |θ_k| at the box center, (k,)
    float64 numpy, from the frozen assembly."""
    box, fom, phys = config["mu_box"], config["fom"], config["physics"]
    center = {k: torch.tensor([0.5 * (lo + hi)], dtype=torch.float64,
                              device=device) for k, (lo, hi) in box.items()}
    ts = time_grid(fom, device=device)[:, None]
    out = {}
    for name in config["sources"]:
        ent = assembly.entries(name, dofs[name], center, ts, int(fom["nx"]),
                               L0=float(fom["L0"]), gamma=phys["gamma"],
                               viscosity=phys["viscosity"])
        out[name] = ent.abs().amax(dim=(1, 2)).clamp(min=1e-300).cpu().numpy()
    return out


class _Draw:
    """Random numbers of one generator on ``device``, float64."""

    def __init__(self, seed, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def normal(self, *shape):
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=torch.float64)

    def uniform(self, lo, hi, *shape):
        u = torch.rand(shape, generator=self.gen, device=self.device,
                       dtype=torch.float64)
        return lo + (hi - lo) * u

    def dofs(self, nh, k, matrix):
        rows = torch.randperm(nh - 2, generator=self.gen,
                              device=self.device)[:k] + 1
        if not matrix:
            return rows[:, None].cpu().numpy()
        cols = rows + torch.randint(-1, 2, (k,), generator=self.gen,
                                    device=self.device)
        cols[0] = rows[0]                 # the first entry on the diagonal
        return torch.stack([rows, cols], dim=1).cpu().numpy()


def _combines(draw, scales, W, N, k, sources):
    """(W, N², k) matrix and (W, N, k) vector combines of one cell."""
    out = {}
    eye = torch.eye(N, dtype=torch.float64, device=draw.device)
    for name in sources:
        inv = torch.as_tensor(1.0 / scales[name], device=draw.device)
        if name == "rhs_vec":
            out[name] = 0.1 * draw.normal(W, N, k) * inv
            continue
        C = draw.normal(W, N, N, k) * (0.005 if name == "mass" else 0.01)
        if name == "mass":
            C[..., 0] += eye
        elif name == "stiffness":
            C[..., 0] += 2.0 * eye
        out[name] = (C * inv).reshape(W, N * N, k)
    return out


def _cell(draw, nh, nt, scales, W, N, k, sources):
    """A cell's payload keys: bounds, Vs, transfers, combine_<source>,
    trilinear (all float64 numpy)."""
    combines = _combines(draw, scales, W, N, k, sources)
    ends = draw.normal(W, 2, N)
    transfers = torch.linalg.qr(draw.normal(W - 1, N, N))[0]
    tri = 0.02 * draw.normal(W, N * N, N)
    Vs = np.zeros((W, nh, N))
    ends = ends.cpu().numpy()
    Vs[:, 0], Vs[:, -1] = ends[:, 0], ends[:, 1]
    out = {"bounds": np.linspace(0, nt, W + 1).astype(np.int64), "Vs": Vs,
           "transfers": transfers.cpu().numpy(),
           "trilinear": tri.cpu().numpy()}
    for name, C in combines.items():
        out[f"combine_{name}"] = C.cpu().numpy()
    return out


def _law(draw, config):
    """A guarded dilation law's payload keys (``dilation_`` stripped):
    d(μ) = 1 + s·(a0 − center), clamped at the floor, its guard cloud
    ``guard_points`` a0 values across the box, range-normalized."""
    law = config["law"]
    lo, hi = config["mu_box"][law["feature"]]
    s = float(draw.uniform(law["slope"][0], law["slope"][1], 1)[0])
    feats = draw.uniform(lo, hi, law["guard_points"], 1).cpu().numpy()
    return {"names": np.array([law["feature"]]),
            "coef": np.array([1.0 - law["center"] * s, s]),
            "floor": np.float64(law["floor"]),
            "guard_feats": feats / (hi - lo),
            "guard_inv_span": np.array([1.0 / (hi - lo)]),
            "guard_dref": np.float64(law["guard_dref"])}


def _common(config, dofs):
    fom = config["fom"]
    out = {f"dofs_{name}": np.asarray(dofs[name]) for name in config["sources"]}
    out.update({f"grid_{k}": np.array(v, np.float64)
                for k, v in config["mu_box"].items()})
    out.update(fom_L0=np.float64(fom["L0"]), fom_nx=np.int64(fom["nx"]),
               fom_tf=np.float64(fom["tf"]), fom_nt=np.int64(fom["nt"]),
               fom_degree=np.int64(fom["degree"]),
               fom_bdf=np.array(str(fom["bdf"])),
               fom_which=np.array(fom["which"]))
    return out


def draw_payload(config, seed, device):
    """The serving payload of ``config`` drawn from ``seed`` on
    ``device``: a fleet (``edges`` and ``c{c}_`` cells) or a global ROM
    (``basis``, ``combine_<source>``, ``trilinear``)."""
    draw = _Draw(stream_seed(seed, ARTIFACT_STREAM), device)
    fom = config["fom"]
    nh, nt, k = int(fom["nx"]) + 1, int(fom["nt"]), config["dofs_per_source"]
    sources = config["sources"]
    dofs = {name: draw.dofs(nh, k, matrix=name != "rhs_vec")
            for name in sources}
    scales = theta_scales(config, dofs, device)
    payload = _common(config, dofs)
    if config["kind"] == "global":
        N = config["N"]
        combines = _combines(draw, scales, 1, N, k, sources)
        ends = draw.normal(2, N).cpu().numpy()
        basis = np.zeros((nh, N))
        basis[0], basis[-1] = ends
        payload["basis"] = basis
        for name, C in combines.items():
            payload[f"combine_{name}"] = C[0].cpu().numpy()
        payload["trilinear"] = (0.02 * draw.normal(N * N, N)).cpu().numpy()
        return payload
    cells = config["cells"]
    payload["edges"] = band_edges(config["mu_box"], len(cells))
    for c, (W, N) in enumerate(cells):
        cell = _cell(draw, nh, nt, scales, W, N, k, sources)
        payload.update({f"c{c}_{key}": v for key, v in cell.items()})
    for c in config.get("registered", []):
        payload.update({f"c{c}_dilation_{key}": v
                        for key, v in _law(draw, config).items()})
    return payload

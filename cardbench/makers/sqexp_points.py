"""A point set and its squared-exponential bandwidth: ``make`` returns the
tuple ``(X, bandwidth)``, X (d, n) one point a column in the
configuration's type on the device, the bandwidth a Python float.

The points are drawn once from ``matrix_seed``: n·d iid standard Gaussian
coordinates, then standardized (each coordinate centred, scaled so that
the mean squared point norm is d). The bandwidth is the median heuristic
over the first ``bandwidth_points`` points in that order: the square root
of the median of their nonzero squared distances (the lower median, as
``torch.median`` takes it). The run's seed then orders the points: every
seed gives the same kernel operator, its rows and columns in another
order."""
import torch

from cardbench import inputs


def make(config: dict, seed: int, device):
    gen = config["generator"]
    n, d = config["shape"]
    dtype = getattr(torch, config["dtype"])
    X = torch.randn((d, n), generator=inputs.generator(gen["matrix_seed"], 1,
                                                       device),
                    dtype=dtype, device=device)
    X = X - X.mean(dim=1, keepdim=True)
    X = X / torch.sqrt(torch.mean(torch.sum(X * X, dim=0)) / d)
    sub = X[:, :gen["bandwidth_points"]].double()
    d2 = ((sub[:, :, None] - sub[:, None, :]) ** 2).sum(0)
    bandwidth = float(torch.sqrt(torch.median(d2[d2 > 0])))
    order = torch.randperm(n, generator=inputs.generator(seed, 5, device),
                           device=device)
    return X.index_select(1, order).contiguous(), bandwidth

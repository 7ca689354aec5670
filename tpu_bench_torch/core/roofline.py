"""Physical bandwidth ceilings from measured directional bandwidths (port of
tpu_bench/core/roofline.py, the same functions with the same results).

Device memory need not read and write at one rate, so a single "peak"
number can over-state what a mixed-traffic kernel does.  Two bounds
bracket the achievable combined rate of a kernel moving R read and W
written bytes:

    shared-bus:   t >= R / bw_read + W / bw_write      (no overlap)
    full-duplex:  t >= max(R / bw_read, W / bw_write)  (perfect overlap)

benchmarks/ceilings.py measures the directional rates and the STREAM and
1R:{2,4,8}W mixes on the card (committed for the H100 in
artifacts/h100/ceilings/ceilings.log); these helpers turn them into
per-benchmark ceilings, so every throughput row can be judged against what
the card can do for its traffic mix.  The reference applies the same logic
implicitly by comparing against STREAM numbers
(benchmark02/benchmark02.cc:255-259 counts 2R+1W).  chip_smoke.py holds
every sweep row above twice the L2 to honesty_cap_mix / honesty_cap_bwdtrans
of the ceilings measured in the same run.
"""

from __future__ import annotations


def mixed_bandwidth(bw_read: float, bw_write: float, r_bytes: float,
                    w_bytes: float, duplex: bool = False) -> float:
    """Achievable combined GB/s for a kernel reading r_bytes and writing
    w_bytes per repetition (bytes in any common unit).  duplex=False gives
    the shared-bus (no-overlap) bound; duplex=True the full-duplex upper
    bound."""
    if r_bytes <= 0:
        return bw_write
    if w_bytes <= 0:
        return bw_read
    if duplex:
        t = max(r_bytes / bw_read, w_bytes / bw_write)
    else:
        t = r_bytes / bw_read + w_bytes / bw_write
    return (r_bytes + w_bytes) / t


def stream_add_ceiling(bw_read: float, bw_write: float,
                       duplex: bool = False) -> float:
    """b02 ceiling in its own 3x-counted GB/s metric (2 reads + 1 write,
    benchmark02/benchmark02.cc:255)."""
    return mixed_bandwidth(bw_read, bw_write, 2.0, 1.0, duplex)


def bwdtrans_ceiling_gdofs(bw_read: float, bw_write: float, nq: int,
                           dim: int, itemsize: int,
                           duplex: bool = False) -> float:
    """b04/b05 physical peak in GDOF/s for quadrature order nq (uniform per
    direction, nm = nq - 1): each element streams nm^dim values in and
    nq^dim out; DOF counting is input modes (benchmark04.cc:1044,
    benchmark05.cc:1408)."""
    nm, q = (nq - 1) ** dim, nq ** dim
    r_bytes = nm * itemsize
    w_bytes = q * itemsize
    bw = mixed_bandwidth(bw_read, bw_write, r_bytes, w_bytes, duplex)
    bytes_per_dof = (r_bytes + w_bytes) / nm
    return bw / bytes_per_dof


def matvec_ceiling_gbs(bw_read: float) -> float:
    """b03 ceiling in its own metric (counts A-matrix reads only,
    benchmark03/benchmark03.cc:332): read-dominated, so the read rate."""
    return bw_read


# ---------------------------------------------------------------------------
# empirical per-mix bounds
# ---------------------------------------------------------------------------

# Probe ladder measured by benchmarks/ceilings.py: write fraction of the
# mix -> keys whose max is the card's measured combined rate there.  The
# expand 1R:{2,4,8}W probes pin the write-heavy regime the BwdTrans
# benchmarks live in (up to 1R:8W at 3D nq=2).
PROBE_LADDER = (
    (0.0, ("read",)),
    (1.0 / 3.0, ("add_3x", "triad_3x")),
    (0.5, ("copy_2x", "scale_2x")),
    (2.0 / 3.0, ("expand2",)),
    (0.8, ("expand4",)),
    (8.0 / 9.0, ("expand8",)),
    (1.0, ("write",)),
)


def empirical_mix_bandwidth(bw: dict, r_bytes: float, w_bytes: float):
    """Measured-achievable combined GB/s for an R:W byte mix, linearly
    interpolated in write fraction over the probe ladder: a tighter cap
    than full-duplex, which an inflated row could pass.  Returns None when
    bw lacks the bracketing probes (e.g. no expand probes); callers fall
    back to the full-duplex bound."""
    total = r_bytes + w_bytes
    if total <= 0:
        return None
    wf = w_bytes / total
    pts = []
    for frac, keys in PROBE_LADDER:
        vals = [bw[k] for k in keys if k in bw]
        if vals:
            pts.append((frac, max(vals)))
    lo = [p for p in pts if p[0] <= wf]
    hi = [p for p in pts if p[0] >= wf]
    if not lo or not hi:
        return None
    (f0, v0), (f1, v1) = lo[-1], hi[0]
    if f1 == f0:
        return v0
    return v0 + (v1 - v0) * (wf - f0) / (f1 - f0)


def empirical_bwdtrans_gdofs(bw: dict, nq: int, dim: int, itemsize: int):
    """Empirical b04/b05 cap in GDOF/s (None without the expand probes)."""
    nm, q = (nq - 1) ** dim, nq ** dim
    rate = empirical_mix_bandwidth(bw, nm * itemsize, q * itemsize)
    if rate is None:
        return None
    bytes_per_dof = (nm + q) * itemsize / nm
    return rate / bytes_per_dof


def honesty_cap_mix(bw: dict, r_bytes: float, w_bytes: float) -> float:
    """The honesty bound for an R:W mix (GB/s): the empirical probe
    interpolation when bw carries the expand probes, else the full-duplex
    bound."""
    v = empirical_mix_bandwidth(bw, r_bytes, w_bytes)
    if v is None:
        v = mixed_bandwidth(bw["read"], bw["write"], r_bytes, w_bytes,
                            duplex=True)
    return v


def honesty_cap_bwdtrans(bw: dict, nq: int, dim: int, itemsize: int) -> float:
    """The b04/b05 honesty bound in GDOF/s (see honesty_cap_mix)."""
    v = empirical_bwdtrans_gdofs(bw, nq, dim, itemsize)
    if v is None:
        v = bwdtrans_ceiling_gdofs(bw["read"], bw["write"], nq, dim,
                                   itemsize, duplex=True)
    return v

"""SPE10 benchmark support: permeability field + heterogeneous Darcy driver.

Rebuild of reference src/SPE10/InversePermeabilityFunction.{hpp,cpp} and
examples/MultigridTestSPE10.cpp: the SPE10 model-2 field is 60 x 220 x 85
cells of size 20 x 10 x 2 ft with per-cell diagonal permeability (kx ky kz);
the driver solves the mixed Darcy problem with inverse-permeability-weighted
Hdiv mass and (optionally) spectral Hdiv-L2 coarse spaces.

The spe_perm.dat data file is not distributed with the reference repo (it is
an external download); read_spe10_permeability reads the standard format when
available, and synthetic_spe10_field generates a statistically similar
log-normal layered field for self-contained runs and benchmarks.
"""

from dataclasses import dataclass
import numpy as np

from parelag_tpu.mesh.mesh import hex_grid_mesh

SPE10_CELLS = (60, 220, 85)
SPE10_SIZES = (20.0, 10.0, 2.0)


@dataclass
class PermeabilityField:
    """Per-cell inverse permeability, (Nx, Ny, Nz, 3) layout."""
    inv_perm: np.ndarray
    cells: tuple
    sizes: tuple

    def inverse_permeability(self, p) -> np.ndarray:
        """Pointwise diagonal inverse permeability at coordinates p
        (..., 3) -> (..., 3) (InversePermeabilityFunction::
        InversePermeability, InversePermeabilityFunction.cpp:120+)."""
        nx, ny, nz = self.cells
        hx, hy, hz = self.sizes
        i = np.clip((p[..., 0] / hx).astype(np.int64), 0, nx - 1)
        j = np.clip((p[..., 1] / hy).astype(np.int64), 0, ny - 1)
        k = np.clip((p[..., 2] / hz).astype(np.int64), 0, nz - 1)
        return self.inv_perm[i, j, k]

    def slice_2d(self, k):
        """XY slice (Set2DSlice semantics)."""
        out = PermeabilityField(self.inv_perm[:, :, k:k + 1],
                                (self.cells[0], self.cells[1], 1),
                                self.sizes)
        return out


def read_spe10_permeability(path, cells=SPE10_CELLS,
                            sizes=SPE10_SIZES) -> PermeabilityField:
    """Read spe_perm.dat: three blocks (kx, ky, kz), Fortran-order loops
    k-j-i; stores 1/k (ReadPermeabilityFile,
    InversePermeabilityFunction.cpp:57-95)."""
    nx, ny, nz = cells
    data = np.fromfile(path, sep=" ")
    assert data.size >= 3 * nx * ny * nz, "truncated SPE10 file"
    comp = data[: 3 * nx * ny * nz].reshape(3, nz, ny, nx)
    inv = 1.0 / comp
    # -> (Nx, Ny, Nz, 3)
    return PermeabilityField(
        np.moveaxis(inv, (0, 1, 2, 3), (3, 2, 1, 0)), cells, sizes)


def synthetic_spe10_field(cells=(16, 16, 8), sizes=SPE10_SIZES,
                          seed=0, layers=4,
                          log_sigma=2.0) -> PermeabilityField:
    """Layered log-normal permeability with SPE10-like contrast (smooth in
    xy, strongly layered in z) for self-contained runs."""
    nx, ny, nz = cells
    rng = np.random.RandomState(seed)
    # smooth xy fields per z-layer-group
    k = np.empty((nx, ny, nz))
    layer_of = (np.arange(nz) * layers // nz)
    for lay in range(layers):
        base = rng.randn(nx // 4 + 2, ny // 4 + 2)
        # bilinear upsample for smoothness
        xi = np.linspace(0, base.shape[0] - 1.001, nx)
        yi = np.linspace(0, base.shape[1] - 1.001, ny)
        x0 = xi.astype(int)
        y0 = yi.astype(int)
        fx = (xi - x0)[:, None]
        fy = (yi - y0)[None, :]
        smooth = ((1 - fx) * (1 - fy) * base[np.ix_(x0, y0)]
                  + fx * (1 - fy) * base[np.ix_(x0 + 1, y0)]
                  + (1 - fx) * fy * base[np.ix_(x0, y0 + 1)]
                  + fx * fy * base[np.ix_(x0 + 1, y0 + 1)])
        shift = rng.randn() * 1.5
        for z in np.nonzero(layer_of == lay)[0]:
            k[:, :, z] = np.exp(log_sigma * smooth + shift)
    inv = np.empty((nx, ny, nz, 3))
    inv[..., 0] = 1.0 / k
    inv[..., 1] = 1.0 / k
    inv[..., 2] = 10.0 / k        # anisotropy in z
    return PermeabilityField(inv, cells, sizes)


def spe10_darcy(field: PermeabilityField = None, cells=(16, 16, 8),
                nref=0, n_levels=2, coarsening_factor=8,
                spectral=False, spect_tol=0.002, max_evects=5,
                svd_tol=1e-9, solver="hybridization",
                mult_solver="auto", seed=0):
    """Heterogeneous-permeability mixed Darcy solve with AMGe upscaling
    (MultigridTestSPE10 flow). Returns dict with solutions, errors and
    solver info."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    from parelag_tpu.topology.topology import AgglomeratedTopology
    from parelag_tpu.amge.fespace import DeRhamSequenceFE
    from parelag_tpu.amge import hexfe
    from parelag_tpu.amge.hybridization import HybridHdivL2
    from parelag_tpu.amge.spectral import (
        compute_local_hdiv_l2_spectral_targets)
    from parelag_tpu.partitioning.partitioners import graph_partition

    if field is None:
        field = synthetic_spe10_field(cells, seed=seed)
    nx, ny, nz = field.cells
    hx, hy, hz = field.sizes
    mesh = hex_grid_mesh(nx, ny, nz, nx * hx, ny * hy, nz * hz)
    for _ in range(nref):
        mesh = mesh.uniform_refinement()

    level_ne = [mesh.num_elements]
    for _ in range(n_levels - 1):
        level_ne.append(max(level_ne[-1] // coarsening_factor, 1))

    topos = [AgglomeratedTopology.from_mesh(mesh)]
    for il in range(n_levels - 1):
        part = graph_partition(topos[il].local_element_element(),
                               level_ne[il + 1], seed=0)
        topos.append(topos[il].coarsen_local_partitioning(part))

    seq0 = DeRhamSequenceFE(topos[0], mesh)
    seq0.jform_start = 2

    def kinv_scalar(p):
        # isotropic scalar weight (mean of the diagonal); the full diagonal
        # tensor variant scales each velocity component in hexfe
        return field.inverse_permeability(p).mean(axis=-1)

    seq0.replace_mass_integrator(2, kinv_scalar)
    seq0.set_upscaling_targets(0)
    seqs = [seq0]
    for il in range(n_levels - 1):
        s = seqs[il]
        if spectral:
            s.agglomerate_dofs()
            tr, l2 = compute_local_hdiv_l2_spectral_targets(
                s, spect_tol, max_evects)
            s.set_local_targets(1, 2, tr)
            s.set_local_targets(0, 3, l2)
        seqs.append(s.coarsen(svd_tol=svd_tol))

    # unit source, natural pressure BC
    uform, pform = 2, 3
    vols = hexfe.hex_volumes(seqs[0].mesh.vertices[seqs[0].mesh.elements])
    Ml = [s.compute_mass_operator(uform) for s in seqs]
    Wl = [s.compute_mass_operator(pform) for s in seqs]
    Dl = [s.D[uform] for s in seqs]
    rhs_u = [np.zeros(seqs[0].dof[uform].ndofs)]
    rhs_p = [vols.copy()]
    for i in range(n_levels - 1):
        rhs_u.append(seqs[i].P[uform].T @ rhs_u[i])
        rhs_p.append(seqs[i].P[pform].T @ rhs_p[i])

    import time as _time
    # mult_solver may be a tuple of solver names: every solver runs on
    # the SAME built hierarchy per level (the bench's device-vs-host
    # multiplier comparison without paying setup twice); the FIRST one
    # provides the reported solution, solve_s_by records each timing
    mult_solvers = ((mult_solver,) if isinstance(mult_solver, str)
                    else tuple(mult_solver))
    out = {"ndofs": [], "iters": [], "u": [], "p": [], "solve_s": [],
           "solve_s_by": {ms: [] for ms in mult_solvers},
           "mult_iters_by": {ms: [] for ms in mult_solvers},
           "u_by": {ms: [] for ms in mult_solvers}}
    for k in range(n_levels):
        s = seqs[k]
        if solver == "hybridization":
            hyb = HybridHdivL2(s)
            # mult_solver="auto" routes the multiplier PCG to the
            # accelerator when one is attached (f32 device CG + f64 host
            # refinement; shapes padded to power-of-two buckets so every
            # level and size share ONE compiled solver) and to host scipy
            # CG otherwise
            u = p = None
            for ms in mult_solvers:
                _t0 = _time.time()
                uu, pp = hyb.solve(rhs_u[k], rhs_p[k], solver=ms,
                                   rtol=1e-8, rescale=True)
                out["solve_s_by"][ms].append(_time.time() - _t0)
                out["mult_iters_by"][ms].append(
                    getattr(hyb, "last_iterations", None))
                out["u_by"][ms].append(uu)
                if u is None:
                    u, p = uu, pp
            out["iters"].append(hyb.n_mult)
            out["solve_s"].append(out["solve_s_by"][mult_solvers[0]][-1])
        else:
            B = (Wl[k] @ Dl[k]).tocsr()
            A = sp.bmat([[Ml[k], B.T], [B, None]], format="csc")
            _t0 = _time.time()
            x = spla.spsolve(A, np.concatenate([rhs_u[k], rhs_p[k]]))
            u, p = x[: B.shape[1]], x[B.shape[1]:]
            out["iters"].append(0)
            out["solve_s"].append(_time.time() - _t0)
        out["u"].append(u)
        out["p"].append(p)
        out["ndofs"].append(s.dof[uform].ndofs + s.dof[pform].ndofs)

    # upscaling errors vs fine
    def u_rel(us):
        hu = us[-1]
        for j in range(n_levels - 1, 0, -1):
            hu = seqs[j - 1].P[uform] @ hu
        du = hu - us[0]
        return (float(np.sqrt(du @ (Ml[0] @ du)))
                / float(np.sqrt(us[0] @ (Ml[0] @ us[0]))))

    hu, hp = out["u"][-1], out["p"][-1]
    for j in range(n_levels - 1, 0, -1):
        hu = seqs[j - 1].P[uform] @ hu
        hp = seqs[j - 1].P[pform] @ hp
    du = hu - out["u"][0]
    dp = hp - out["p"][0]
    out["u_l2_err"] = float(np.sqrt(du @ (Ml[0] @ du)))
    out["p_l2_err"] = float(np.sqrt(dp @ (Wl[0] @ dp)))
    un = out["u"][0]
    out["u_l2_rel"] = out["u_l2_err"] / float(np.sqrt(un @ (Ml[0] @ un)))
    if solver == "hybridization":
        out["u_l2_rel_by"] = {ms: u_rel(us) for ms, us in out["u_by"].items()}
    return out

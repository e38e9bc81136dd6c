"""Legacy-VTK mesh/field export.

The reference visualizes through GLVis sockets and MFEM VisIt
DataCollections (Visualization.cpp:30-320, MultiVector.cpp saves). In a
batch setting there is no socket target, so the equivalent artifact is
a portable VTK file per level: mesh + cell/point data, loadable in
ParaView/VisIt. Writes ASCII legacy .vtk (no external deps).
"""

import numpy as np

_VTK_CELL = {"hex": 12, "tet": 10, "quad": 9}


def write_vtk(mesh, path, point_data=None, cell_data=None,
              title="parelag_tpu"):
    """Write the mesh plus named nodal/cell scalar (1d) or vector (2d)
    fields. point_data/cell_data: dict name -> array."""
    verts = np.asarray(mesh.vertices, dtype=np.float64)
    elems = np.asarray(mesh.elements)
    if verts.shape[1] == 2:
        verts = np.concatenate(
            [verts, np.zeros((verts.shape[0], 1))], axis=1)
    ctype = _VTK_CELL[mesh.kind]
    nv = elems.shape[1]
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(f"{title}\nASCII\nDATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {verts.shape[0]} double\n")
        np.savetxt(f, verts, fmt="%.9g")
        f.write(f"CELLS {elems.shape[0]} {elems.shape[0] * (nv + 1)}\n")
        np.savetxt(
            f, np.concatenate(
                [np.full((elems.shape[0], 1), nv), elems], axis=1),
            fmt="%d")
        f.write(f"CELL_TYPES {elems.shape[0]}\n")
        np.savetxt(f, np.full(elems.shape[0], ctype, dtype=np.int64),
                   fmt="%d")
        for tag, data in (("POINT_DATA", point_data),
                          ("CELL_DATA", cell_data)):
            if not data:
                continue
            n = verts.shape[0] if tag == "POINT_DATA" else elems.shape[0]
            f.write(f"{tag} {n}\n")
            for name, arr in data.items():
                arr = np.asarray(arr, dtype=np.float64)
                if arr.ndim == 1:
                    f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE "
                            "default\n")
                    np.savetxt(f, arr, fmt="%.9g")
                else:
                    if arr.shape[1] == 2:
                        arr = np.concatenate(
                            [arr, np.zeros((arr.shape[0], 1))], axis=1)
                    f.write(f"VECTORS {name} double\n")
                    np.savetxt(f, arr, fmt="%.9g")


def agglomerate_cell_data(topo, level_topo=None):
    """Push the coarsest-level partition and a greedy coloring down to fine
    elements (the reference's ShowTopologyAgglomeratedElements,
    Visualization.cpp:30-110: WedgeMultTranspose down the topology chain).

    topo: the FINEST AgglomeratedTopology; level_topo: the coarsened level
    whose agglomerates to show (default: topo.coarser chain end).
    Returns dict with 'partitioning' and 'coloring' per fine element."""
    from parelag_tpu.topology.coloring import get_element_coloring

    coarse = level_topo
    if coarse is None:
        coarse = topo
        while coarse.coarser is not None:
            coarse = coarse.coarser
    n_ae = coarse.num_entities(0)
    part = np.arange(n_ae, dtype=np.int64)
    colors = get_element_coloring(coarse.local_element_element())

    # walk back down to the finest level
    it = coarse
    while it.finer is not None:
        fine = it.finer
        AE_e = fine.AEntity_entity[0].tocsc()
        # fine element -> its agglomerate (columns of AE_e^T)
        owner = np.empty(AE_e.shape[1], dtype=np.int64)
        coo = AE_e.tocoo()
        owner[coo.col] = coo.row
        part = part[owner]
        colors = colors[owner]
        it = fine
    return {"partitioning": part.astype(np.float64),
            "coloring": colors.astype(np.float64)}


def save_agglomerates_vtk(topo, mesh, path, level_topo=None):
    """One-call agglomerate visualization artifact."""
    write_vtk(mesh, path, cell_data=agglomerate_cell_data(topo, level_topo))


def save_basis_functions_vtk(seq_fe, jform, coarse_dofs, path_prefix):
    """Export coarse basis functions (columns of P[jform]) as VTK fields —
    the reference's HdivL2ExtensionVisualize.cpp GLVis loop, batch form.
    Scalar forms (H1/L2) export nodal/cell scalars; vector forms export
    cell-centered vectors reconstructed from the FE dofs. Writes one file
    per coarse dof; returns the file list."""
    import scipy.sparse as sp

    P = sp.csc_matrix(seq_fe.P[jform])
    mesh = seq_fe.mesh
    nforms = seq_fe.nforms
    files = []
    for cd in coarse_dofs:
        col = np.asarray(P[:, cd].todense()).ravel()
        out = f"{path_prefix}_form{jform}_dof{cd}.vtk"
        if jform == 0:
            write_vtk(mesh, out, point_data={"basis": col})
        elif jform == nforms - 1:
            write_vtk(mesh, out, cell_data={"basis": col})
        else:
            ec = mesh.vertices[mesh.elements]
            shapes = seq_fe._vector_shapes_at_quad(jform, ec)
            ents = seq_fe.ents
            if jform == nforms - 2:        # Hdiv
                coeff = col[ents.elem_face] * ents.elem_face_sign
            else:                          # Hcurl
                coeff = col[ents.elem_edge] * ents.elem_edge_sign
            field = np.einsum("nqia,ni->nqa", shapes, coeff).mean(axis=1)
            write_vtk(mesh, out, cell_data={"basis": field})
        files.append(out)
    return files

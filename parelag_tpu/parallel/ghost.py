"""GhostMap: standalone one-layer ghost exchange over distributed entities.

Reference: src/structures/GhostMap.hpp:51 — DG-style neighbor-data
exchange built on SharingMap (Distribute = owner -> ghost copies,
Assemble = sum ghost contributions -> owner). The rebuild keeps
the same two verbs as precomputed index plans over the virtual-global
layout (owner * n_loc + slot, the parallel.sharding convention):

* host execution — plain gathers / scatter-adds (the reference semantics,
  used by the setup phase);
* device execution — ONE shard_map collective each over the `dd` mesh
  axis: distribute = all_gather + ghost-slot gather; assemble =
  scatter-add into the virtual layout + psum (exactly
  SharingMap.Assemble's additive reduction as a collective).

Validated host == device == hand summation by tests/test_ghost.py.
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class GhostMap:
    ndev: int
    n_loc: int                 # padded owned entities per device
    n_ent: int
    owner: np.ndarray          # (n_ent,)
    slot: np.ndarray           # (n_ent,)
    virt: np.ndarray           # (n_ent,) = owner * n_loc + slot
    ghosts: list               # per rank: sorted ghost entity ids

    @classmethod
    def build(cls, owner, reads):
        """owner: owning rank per entity; reads[r]: entity ids rank r
        references (its own + neighbors'; ghosts = reads - owned). The
        rank count comes from len(reads): ranks that own nothing still
        read (and must receive) ghosts."""
        from parelag_tpu.parallel.sharding import owner_layout
        owner = np.asarray(owner)
        n = owner.size
        ndev = max(len(reads),
                   int(owner.max()) + 1 if n else 1)
        slot, n_loc, _ = owner_layout(owner, ndev)
        ghosts = []
        for r in range(ndev):
            ids = np.unique(np.asarray(reads[r]))
            ghosts.append(ids[owner[ids] != r])
        return cls(ndev, n_loc, n, owner, slot, owner * n_loc + slot,
                   ghosts)

    def owned(self, r):
        return np.where(self.owner == r)[0]

    # ------------------------- host execution ------------------------- #
    def distribute(self, values):
        """Owner values (n_ent, ...) -> per-rank ghost copies
        [(n_ghost_r, ...)] (SharingMap::Distribute)."""
        values = np.asarray(values)
        return [values[g] for g in self.ghosts]

    def assemble(self, own_values, ghost_contrib):
        """Sum ghost contributions into owner values
        (SharingMap::Assemble): own_values (n_ent, ...) modified copies
        per owner + per-rank arrays aligned with self.ghosts."""
        out = np.array(own_values, copy=True)
        for g, c in zip(self.ghosts, ghost_contrib):
            np.add.at(out, g, np.asarray(c))
        return out

    # ------------------------ device execution ------------------------ #
    def device_fns(self, mesh):
        """(gvirt, distribute_fn, assemble_fn) as jitted shard_map
        collectives. Block layout: (ndev, n_loc) owned values; ghosts
        padded to the max ghost count (validity mask from
        `ghost_mask()`); padded contribution slots route to a scratch
        slot and are discarded."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from parelag_tpu.parallel.sharding import shard_map

        m_g = max([g.size for g in self.ghosts] + [1])
        ndev, n_loc = self.ndev, self.n_loc
        # padding slots point at a scratch slot PAST the owned range so a
        # nonzero padded contribution can never alias entity 0; the
        # scratch column is dropped after the psum
        gv = np.full((self.ndev, m_g), ndev * n_loc, dtype=np.int64)
        for r, g in enumerate(self.ghosts):
            gv[r, :g.size] = self.virt[g]
        gvirt = jnp.asarray(gv)

        @jax.jit
        @lambda f: shard_map(f, mesh=mesh,
                             in_specs=(P("dd"), P("dd")),
                             out_specs=P("dd"))
        def distribute_fn(x_blk, gv_blk):
            xg = jax.lax.all_gather(x_blk, "dd").reshape(-1)
            return xg[gv_blk[0]][None, :]

        @jax.jit
        @lambda f: shard_map(f, mesh=mesh,
                             in_specs=(P("dd"), P("dd"), P("dd")),
                             out_specs=P("dd"))
        def assemble_fn(x_blk, contrib_blk, gv_blk):
            buf = jnp.zeros(ndev * n_loc + 1, x_blk.dtype).at[
                gv_blk[0]].add(contrib_blk[0])[:ndev * n_loc]
            tot = jax.lax.psum(buf.reshape(ndev, n_loc), "dd")
            me = jax.lax.axis_index("dd")
            own = jax.lax.dynamic_slice_in_dim(
                tot.reshape(-1), me * n_loc, n_loc)
            return x_blk + own[None, :]

        return gvirt, distribute_fn, assemble_fn

    def ghost_mask(self):
        """(ndev, m_g) bool: which padded ghost slots are real."""
        m_g = max([g.size for g in self.ghosts] + [1])
        mask = np.zeros((self.ndev, m_g), dtype=bool)
        for r, g in enumerate(self.ghosts):
            mask[r, :g.size] = True
        return mask

    def to_blocks(self, values):
        """Global (n_ent,) -> (ndev, n_loc) owned blocks."""
        out = np.zeros((self.ndev, self.n_loc),
                       dtype=np.asarray(values).dtype)
        out[self.owner, self.slot] = np.asarray(values)
        return out

    def from_blocks(self, blocks):
        return np.asarray(blocks)[self.owner, self.slot]

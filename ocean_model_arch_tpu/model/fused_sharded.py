"""Fused step composed with SPMD sharding along x over a 1D device mesh
(model/fused_sharded2d.py generalizes it to 2D meshes).

Each step: the 6 prognostic shards exchange their M-row margins with
mesh neighbours via two ppermutes (the only inter-device traffic — the
reference exchanges 14 fields per step, sync.f90; here depth/mask/RHS
fields never leave the device because the fused step recomputes them),
then every shard runs the whole-step update on its margined block.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ModelConfig
from ..core.grid import Grid
from ..core.state import SWState
from ..ops import sw_kernels as swk
from ..ops import fused_step as fsk

M = fsk.margin_for(1)


class FusedShardedSWModel:
    """x-sharded fused model over a 1D mesh of n devices."""

    def __init__(self, grid: Grid, cfg: ModelConfig, tau: float,
                 n_devices: int, devices=None):
        if grid.periodic_x or grid.periodic_y:
            raise ValueError("fused sharded path: periodic unsupported")
        self.grid = grid
        self.cfg = cfg
        self.n = n_devices
        if devices is None:
            devices = jax.devices()[:n_devices]
        self.mesh = Mesh(np.array(devices), ("x",))

        # per-shard local extent covering nx
        xl = -(-grid.nx // n_devices)
        self.xl = xl
        self.Xg = xl * n_devices                 # global domain rows
        self.lay = fsk.FusedLayout(
            nx=grid.nx, ny=grid.ny, X=xl, Xs=xl + 2 * M,
            Ys=grid.ny + 2 * fsk.YPAD, margin=M)

        met = fsk.metrics_profile_from_grid(grid, self.lay)
        self.met = jnp.asarray(met)

        # global embedded statics -> per-shard margined slices (n, Xs, Ys)
        def margined_shards(field2d):
            g = np.zeros((self.Xg, self.lay.Ys), np.float32)
            g[:grid.nx, fsk.YPAD:fsk.YPAD + grid.ny] = np.asarray(field2d)
            gp = np.pad(g, ((M, M), (0, 0)))
            return np.stack([gp[i * xl: i * xl + xl + 2 * M]
                             for i in range(n_devices)])

        self.lu_shards = jnp.asarray(margined_shards(grid.lu))
        self.hr_shards = jnp.asarray(margined_shards(grid.hhq_rest))

        self.n_tracers = (cfg.sw.tracer_num if cfg.sw.use_tracers > 0
                          else 0)
        self.step_raw = fsk.build_fused_sw_step(
            self.lay, None, None, None, float(tau), cfg.sw.time_smooth,
            cfg.sw.full_free_surface, cfg.sw.trans_terms, cfg.sw.ksw_lat,
            mu_const=0.0, n_tracers=self.n_tracers)

    # ------------------------------------------------------------------
    def pack(self, state: SWState):
        """SWState -> (6 + 2*T) sharded (Xg, Ys) arrays."""
        def embed(a):
            g = jnp.zeros((self.Xg, self.lay.Ys), jnp.float32)
            g = g.at[:self.grid.nx,
                     fsk.YPAD:fsk.YPAD + self.grid.ny].set(
                jnp.asarray(a, jnp.float32))
            return jax.device_put(
                g, NamedSharding(self.mesh, P("x", None)))
        fields = [state.ssh, state.sshp, state.ubrtr, state.ubrtrp,
                  state.vbrtr, state.vbrtrp]
        for t in range(self.n_tracers):
            fields += [state.ff[t], state.ffp[t]]
        return tuple(embed(a) for a in fields)

    def extract(self, s6):
        return tuple(a[:self.grid.nx,
                       fsk.YPAD:fsk.YPAD + self.grid.ny] for a in s6)

    # ------------------------------------------------------------------
    def make_runner(self, n_inner: int):
        n = self.n
        fwd = [(i, i + 1) for i in range(n - 1)]
        bwd = [(i + 1, i) for i in range(n - 1)]

        def exchange(f):
            """(xl, Ys) -> (xl+2M, Ys) margined from mesh neighbours."""
            if n == 1:
                return jnp.pad(f, ((M, M), (0, 0)))
            low = lax.ppermute(f[-M:], "x", fwd)
            high = lax.ppermute(f[:M], "x", bwd)
            return jnp.concatenate([low, f, high], axis=0)

        def local_fn(lu_b, hr_b, s6):
            lu_l = lu_b[0]
            hr_l = hr_b[0]

            def one(c, _):
                fields, mx = c
                margined = tuple(exchange(f) for f in fields)
                outs, smax = self.step_raw(lu_l, hr_l, self.met,
                                           *margined)
                return (tuple(o[M:-M] for o in outs),
                        jnp.maximum(mx, smax)), None

            (s6, mx), _ = lax.scan(
                one, (tuple(s6), jnp.zeros((), jnp.float32)), None,
                length=n_inner)
            # per-step |ssh| max (check_ssh_err cadence);
            # NaN compares False
            okl = mx < swk.SSH_ERR_BOUND
            ok = lax.psum(okl.astype(jnp.int32), "x") == n
            return s6, ok

        nf = 6 + 2 * self.n_tracers
        sharded = jax.shard_map(
            local_fn, mesh=self.mesh,
            in_specs=(P("x", None, None), P("x", None, None),
                      tuple(P("x", None) for _ in range(nf))),
            out_specs=(tuple(P("x", None) for _ in range(nf)), P()),
            check_vma=False,
        )

        @jax.jit
        def runner(s6):
            return sharded(self.lu_shards, self.hr_shards, tuple(s6))

        return runner

"""The choice of renderer (counterpart of ``raw_ngp_tpu/train/trainer.py``
``render_any`` ``:232``): the occupancy render when
``cfg.render.occupancy``, else the proposal render of the ``-O2``
preset. The train loss and the eval renderer both render through it."""

from __future__ import annotations

from raw_ngp_torch.render.occupancy import render_occupancy
from raw_ngp_torch.render.proposal import render_proposal


def render_any(field, rays_o, rays_d, aabb, bitfield, *, bg_color,
               rays_ldir=None, annealing=1.0, training: bool = False,
               generator=None, plain: bool = False, coarse_lin=None,
               point_budget=None):
    """Render rays [N, 3] with ``field`` on its configuration's path. The
    occupancy path reads ``bitfield``, ``coarse_lin`` and
    ``point_budget``; the proposal path reads none of them (pass
    None)."""
    if field.spec.cfg.render.occupancy:
        return render_occupancy(
            field, rays_o, rays_d, aabb, bitfield, bg_color=bg_color,
            coarse_lin=coarse_lin, plain=plain, training=training,
            generator=generator, point_budget=point_budget,
            annealing=annealing, rays_ldir=rays_ldir)
    return render_proposal(
        field, rays_o, rays_d, aabb, bg_color=bg_color, rays_ldir=rays_ldir,
        annealing=annealing, training=training, generator=generator,
        plain=plain)

"""Render configuration: the fields the port's renderers read (counterpart
of voxtracer/config.py)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RenderConfig:
    width: int = 256
    height: int = 212
    # "primary" (flat albedo at the first hit), "whitted" (deterministic:
    # NEE sum, perfect mirrors, Fresnel-split glass), "path" (full
    # stochastic light transport, renderer.cpp:1076-1328) or "reproject"
    # (static-camera temporal reuse, render/reproject.py)
    mode: str = "path"
    max_bounces: int = 14
    # samples per pixel the presets carry (the renderers and the CLI take
    # spp as an argument)
    spp: int = 1
    # thin-lens depth of field in path mode (camera.h:68-101): the lens
    # sample draws hash salt 101; the camera's focal_distance and
    # defocus_jitter shape it
    use_dof: bool = False
    aa_strength: float = 1.0  # renderer.h:183 antiAliasingStrength
    activate_sky: bool = True
    sky_fallback: tuple = (0.392, 0.584, 0.829)  # renderer.cpp:2312
    # shadow samples per area light in the all-lights NEE sum
    # (renderer.h:205 numCheckShadowsAreaLight)
    num_area_samples: int = 3
    # evaluate and sum every light at NEE instead of one random light
    # scaled by the light count: same expectation (renderer.cpp:738-764),
    # no variance
    deterministic_lights: bool = False
    # whitted: drop a pending branch whose throughput weight is at most
    # this; it would change its pixel by at most eps x its radiance.  0
    # keeps the whole branch tree.
    whitted_cull_eps: float = 1e-3
    # whitted: trace the Fresnel split's reflected and refracted branches
    # at glass and smoke hits; off, a dielectric hit ends its branch
    whitted_glass_split: bool = True
    # the game's light-kill test (renderer.cpp:1437-1450): a path ray that
    # shades a SMOKE_PLAYER-class cell of volume 0 evaluates the direct
    # light there, and a squared length above light_kill_threshold flags
    # it; render_game_frame returns the frame's OR of the flags
    detect_light_kill: bool = False
    light_kill_threshold: float = 16.0
    # "tile": rays are generated in 8x128-pixel tiles so neighbouring
    # threads trace neighbouring pixels; "scanline": row-major.  Tile order
    # falls back to scanline when width % 128 != 0.
    ray_order: str = "tile"
    # path mode: sort the wavefront by (terminated, morton code of the
    # origin, direction octant) before bounces >= 1, so neighbouring
    # threads trace neighbouring rays again after a diffuse bounce.
    # "auto": on paged scenes (more than 64 volumes, scene/instances
    # .paginate_volumes) with at least compact_min rays; "always"; "none".
    # Dispatch order only: each lane's estimator is unchanged, but the
    # counter-hash streams are per lane, so a reordered frame draws other
    # samples than an unordered one.
    bounce_reorder: str = "auto"
    # re-sort before every k-th bounce from bounce 1 on (1 = every bounce)
    bounce_reorder_period: int = 2
    # path mode: between bounces, partition the surviving rays to a prefix
    # (a stable partition) and trace chunks of n // compact_chunks rays,
    # stopping after the last chunk that holds a live ray.  1 = off.
    # Applied when the wavefront holds at least compact_min rays and
    # compact_chunks divides it, and then in place of the bounce reorder.
    compact_chunks: int = 1
    # the fewest rays the compaction chunks and "auto" reorders
    compact_min: int = 65536
    # the sampler of the path and light streams: "hash" (the counter hash
    # of core/rng.py) or "threefry" (jax.random's streams): the same
    # estimators with other sample values
    rng: str = "hash"
    # path mode, reordered loop: after each re-sort the live rays are a
    # prefix, so trace chunks of n // k rays and stop after the last chunk
    # that holds a live ray.  1 = off; a k that does not divide the
    # wavefront leaves the loop unchunked.
    reorder_compact_chunks: int = 1
    # whitted: sort each queue batch by (live, morton code of the origin,
    # direction octant) before it is traced.  Dispatch order only: each
    # branch's maths is unchanged, and a pixel's sum changes by rounding.
    whitted_sort_batch: bool = False

"""Device kernels (jax.numpy / lax) — the per-frame hot path.

This package is the replacement for the reference's WGSL shaders
and wgpu compute passes (reference src/shaders/, src/render/):

* :mod:`params`     — static config / per-frame uniform pytrees (replaces the
  reference's bind-group uniforms, terrain_bind_group.rs + terrain_view_bind_group.rs)
* :mod:`coords`     — shared coordinate math (functions.wgsl twin)
* :mod:`tile_tree`  — vectorized tile-tree request scan (tile_tree.rs:268-333 twin)
* :mod:`refinement` — level-synchronous UDLOD subdivision with cumsum
  compaction (refine_tiles.wgsl + prepare_prepass.wgsl twin — no atomics)
* :mod:`meshgen`    — CDLOD-morphed vertex generation (vertex.wgsl twin)
* :mod:`sampling`   — atlas gather sampling: bilinear/trilinear/grad + normals
  (attachments.wgsl twin)
* :mod:`preprocess` — split / downsample / stitch / mipmap batched ops
  (preprocess shaders twin)

All functions are pure and jit-compatible; shapes are static, dynamic tile
counts are carried as (buffer, count) pairs with masking.
"""

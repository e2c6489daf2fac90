"""Device-side compute ops: intersection, BVH traversal, BSDF, tonemap.

These are the hot kernels (reference layers L2a/L2b), written as batched
jnp (and one Pallas kernel) over ray megabatches rather than per-ray scalar calls.
"""

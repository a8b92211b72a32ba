"""PyTorch/CUDA port of the privacy-preserving K-means package `repro`.

It imports torch and numpy only, never jax and never `repro`; the JAX
package is the reference it is tested against. Ring elements are int64
tensors holding the same 64-bit words as the reference's uint64 arrays.
"""

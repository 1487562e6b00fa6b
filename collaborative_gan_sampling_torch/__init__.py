"""PyTorch / CUDA port of collaborative GAN sampling for NVIDIA Hopper.

The JAX package ``collaborative_gan_sampling_tpu`` is the reference; this
package imports nothing of it.
"""

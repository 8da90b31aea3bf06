"""PyTorch/CUDA port of spark_rapids_tpu: TPU-native SQL plan acceleration
rebuilt for NVIDIA GPUs. Imports torch and numpy, never jax."""

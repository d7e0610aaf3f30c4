"""tf_faster_rcnn_torch: the Faster R-CNN detector in PyTorch, with CUDA
kernels written for NVIDIA Hopper (sm_90a).

A port of ``tf_faster_rcnn_tpu``, which stays the reference: the modules
mirror its layout (``ops/``, ``models/``, ``engine/``, ``utils/``) and
names, and keep its layouts at the public functions (NHWC images, the same
output dicts). The package imports torch and numpy, never JAX.
"""

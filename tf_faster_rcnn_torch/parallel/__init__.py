"""Data and model parallelism: the process group (``dist``), the
('data', 'model') mesh and the layouts (``mesh``), Megatron tensor
parallelism of the RoI head (``tensor_parallel``) and spatial partitioning
of the backbone head (``spatial``). Port of ``tf_faster_rcnn_tpu/parallel``."""

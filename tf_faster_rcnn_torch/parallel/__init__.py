"""Data parallelism: the process group (``dist``) and the data axis
(``mesh``). Port of ``tf_faster_rcnn_tpu/parallel``; the 'model' axis is
not ported yet (ROADMAP.md, Queue A)."""

"""Multi-process execution over ``torch.distributed`` (vnlb_tpu/parallel/):
halo-sharded H strips (``halo``), site parallelism (``tiled``), the filter
batch split (``tp``), the two passes on two devices (``pipe``), the
collectives they use (``comm``) and a one-host launcher (``launch``)."""

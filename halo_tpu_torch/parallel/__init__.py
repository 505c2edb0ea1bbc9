"""Data parallelism of the port over ``torch.distributed``: one process a
device, each taking a contiguous slice of every global batch (port of
``halo_tpu/parallel``).

``mesh`` sets the process group up from the torchrun environment,
``multihost`` coordinates the processes on the host (the identity without
a group), ``collectives`` holds the all-reduces the train step needs
(with gradients, the synced BatchNorm, the gradient reduction),
``launch`` starts local rank processes and joins them within a
deadline."""

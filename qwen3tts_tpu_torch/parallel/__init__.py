"""Multi-device serving: tensor parallelism (``mesh``) and data-parallel
replicas (``dp``), one process driving every device."""

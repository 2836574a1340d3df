"""Multi-device paths of the port: the process group and its wire
(``mesh``), the source-partitioned halo exchange (``product_shard``) and the
sharded detection trunks (``sharded_detector``). Data-parallel training
takes a :class:`~genie_tpu_torch.parallel.mesh.Mesh` in
``train/trainer.make_train_step`` and ``workflow.train``."""

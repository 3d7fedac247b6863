"""Parallelism across processes (counterpart of mvae_tpu/parallel/):
`distributed` starts the process group and feeds each rank its rows,
`mesh` lays the ranks out as the JAX mesh's (data, model) grid and places
the parameters over its model axis, `collectives` holds the data-parallel
group's all-reduces (the BN ops', the train step's), `tensor_parallel`
the model axis's autograd collectives, and `data_parallel` the
per-replica alternative."""

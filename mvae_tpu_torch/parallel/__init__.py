"""Data parallelism across processes (counterpart of mvae_tpu/parallel/,
its data-parallel half): `distributed` starts the process group and feeds
each rank its rows, `mesh` describes the data-parallel group, `collectives`
holds the all-reduces the BN ops and the train step run, and
`data_parallel` the per-replica alternative."""

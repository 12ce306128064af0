"""The parallel layer on torch.distributed (port of zoomearth_tpu/parallel/): a
(data, fsdp, tensor) mesh over the world's ranks, the parameter sharding rules, the
collectives of the sharded training step, multi-process start-up and the
multi-process dryrun."""

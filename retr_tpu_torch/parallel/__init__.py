"""Multi-GPU: the (dp, mp) mesh over torch.distributed (``mesh``) and the
sharded evaluation sweep (``sweep``)."""

"""Multi-device training over torch.distributed: the process grid and its
sharding rules (parallel.mesh), the runtime (parallel.distributed) and the
autograd-aware collectives (parallel.collectives)."""

"""Multi-device training (port of repro.parallel): the sharding rules, FSDP
storage and collectives, the tensor-parallel CADC linear, the ternary
weight store."""

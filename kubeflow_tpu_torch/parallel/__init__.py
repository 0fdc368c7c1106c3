"""Training-step construction, process rendezvous, the gang's
collectives, and the 6-axis mesh with its logical-axis sharding (data
parallelism over a torch.distributed group; fsdp and tp over a mesh)."""

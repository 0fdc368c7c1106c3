"""Training-step construction, process rendezvous and the gang's
collectives (data parallelism over a torch.distributed group)."""

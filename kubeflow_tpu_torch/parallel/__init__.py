"""Training-step construction and process rendezvous (one device in this
slice)."""

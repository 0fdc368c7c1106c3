"""Model definitions of the port (Llama for this slice)."""

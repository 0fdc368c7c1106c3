"""Model definitions of the port (Llama and BERT)."""

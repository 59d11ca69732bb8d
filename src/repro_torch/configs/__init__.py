"""Model configurations of the LM stack (plain data)."""

"""LM serving: batched prefill + decode with sampling, and cascade
serving."""

"""Camera case studies of the port: synthetic workloads, motion gate,
Viola-Jones front-end, face-auth NN and the §III executor."""

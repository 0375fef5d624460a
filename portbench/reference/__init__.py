"""Plain references: the same semantics as the port's paths, written
again in plain PyTorch from the generated inputs. Nothing here imports the
port, JAX or the JAX package. Each runs in float64 to judge the program,
and in bfloat16 as the control that a check has to fail."""

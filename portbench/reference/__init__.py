"""Plain PyTorch fp32 references of the served model families.  They
import nothing of the program: they read the published configuration's
keys and the weights the benchmark drew, and work out positions, caches
and routing themselves."""

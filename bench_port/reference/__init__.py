"""The plain reference that decides `correct`: a GF(256) field, the
stated codes' parity rows, SeaweedFS's stripe layout and a table-lookup
coded matmul in plain PyTorch. It imports nothing of the program."""

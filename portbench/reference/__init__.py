"""Plain references, independent of the program: a dense GQA decoder
(serving logits, a training loss) and AdamW, in float32 PyTorch with
TF32 off.  Nothing here imports the program, the JAX package or JAX."""

"""The plain reference that decides `correct`: a frozen float32 copy of
`dcf_torch`'s modules at commit fab139f in which every CUDA kernel and
compiled host call is replaced by its plain PyTorch or numpy version. It
imports nothing of `dcf_torch` and takes nothing the program made."""

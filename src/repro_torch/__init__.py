"""PyTorch/CUDA port of the reference JAX package ``repro``.

It mirrors ``repro``'s layout and names and is held against it on the
same inputs. It imports neither JAX nor ``repro``. Ported so far: the
paged-KV serving path of the decoder LM (llama3-8b), with the paged
decode attention kernel written in CUDA for Hopper
(``repro_torch.kernels``). Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"

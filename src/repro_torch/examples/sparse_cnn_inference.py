"""The paper's own domain: structured-sparse CNN inference (counterpart of
``examples/sparse_cnn_inference.py``; the body is ``launch.cnn``).

  PYTHONPATH=src python -m repro_torch.examples.sparse_cnn_inference \\
      [--device cpu]
"""

from repro_torch.launch.cnn import main

if __name__ == "__main__":
    main()

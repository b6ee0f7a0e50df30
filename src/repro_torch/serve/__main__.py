"""``python -m repro_torch.serve`` — the coloring-service CLI smoke
(:func:`repro_torch.serve.coloring.main`)."""
from .coloring import main

if __name__ == "__main__":
    main()

"""``python -m demucs_tpu_torch``: the separation CLI."""

from demucs_tpu_torch.separate import main

if __name__ == "__main__":
    main()

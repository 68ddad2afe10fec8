from demucs_tpu_torch.grids import main

if __name__ == "__main__":
    main()

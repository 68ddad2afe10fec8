"""Export of the HTDemucs core and of trained models (counterparts of the JAX
package's ``tools/export_stablehlo.py``, ``tools/run_stablehlo.py`` and
``tools/export.py``):

- ``core``: ``torch.export`` of ``HTDemucs.forward_core`` with K3 as the
  registered op ``demucs_tpu_torch::flash_mha``, saved as ``.pt2`` with a
  ``.meta.json``; ``load_core`` loads it onto a device;
- ``run``: the runtime around a loaded core, WAV in, stems out;
- ``release``: a trained XP's checkpoint to a release ``.dmx``.
"""

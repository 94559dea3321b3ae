"""Drop-in compatibility namespace for ``pyAudioDspTools`` users.

    import pyaudiodsptools_tpu.compat as pyAudioDspTools
    pyAudioDspTools.config.initialize(44100, 512)
    f = pyAudioDspTools.CreateLowCutFilter(800)
    out = f.apply(chunk)

Exports the reference's full public API (``/root/reference/pyAudioDspTools/
__init__.py:11-28``) plus its unexported WIP devices (Reverb, BitCrusher) as
first-class citizens, backed by the functional ops.
"""

from . import config
from .devices import (CreateBitCrusher, CreateCompressor, CreateDelay,
                      CreateEQ3Band, CreateEQ3BandFFT, CreateEQ3BandFFTGPU,
                      CreateGate, CreateHardDistortion, CreateHighCutFilter,
                      CreateHighCutFilterGPU, CreateLowCutFilter,
                      CreateLowCutFilterGPU, CreateReverb, CreateSaturator,
                      CreateSoftClipper, CreateTremolo)
from .utility import (CombineChunks, Convert16BitTodBV, ConvertdBVTo16Bit,
                      CreateSinewave, CreateSquarewave, CreateWhitenoise,
                      Dither16BitTo8Bit, Dither32BitIntTo16BitInt, InfodBV,
                      InfodBV16Bit, MakeChunks, MixSignals,
                      MonoWavToNumpy16BitInt, MonoWavToNumpyFloat,
                      NumpyFloatToWav, StereoWavToNumpyFloat, VolumeChange)

__all__ = [
    "config",
    "CreateBitCrusher", "CreateCompressor", "CreateDelay", "CreateEQ3Band",
    "CreateEQ3BandFFT", "CreateEQ3BandFFTGPU", "CreateGate",
    "CreateHardDistortion", "CreateHighCutFilter", "CreateHighCutFilterGPU",
    "CreateLowCutFilter", "CreateLowCutFilterGPU", "CreateReverb",
    "CreateSaturator", "CreateSoftClipper", "CreateTremolo",
    "CombineChunks", "Convert16BitTodBV", "ConvertdBVTo16Bit",
    "CreateSinewave", "CreateSquarewave", "CreateWhitenoise",
    "Dither16BitTo8Bit", "Dither32BitIntTo16BitInt", "InfodBV", "InfodBV16Bit",
    "MakeChunks", "MixSignals", "MonoWavToNumpy16BitInt", "MonoWavToNumpyFloat",
    "NumpyFloatToWav", "StereoWavToNumpyFloat", "VolumeChange",
]

from .evaluation import compare_bracket, compare_framewise, compare_transcription
from . import matching

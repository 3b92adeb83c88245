"""Host IO: audio and note-event files (``io/audio.py``) and the native
(C++) mmap window loader with prefetch (``io/native_loader.py``)."""

from .audio import (NOTE_EVENT_SCHEMAS, NoteEventSchema, load_audio,
                    load_note_events, note_name_to_midi)
from .native_loader import (NativeWindowLoader, build_native_library,
                            trainer_batches)

__all__ = ["NativeWindowLoader", "build_native_library", "trainer_batches",
           "load_audio", "load_note_events", "NoteEventSchema",
           "NOTE_EVENT_SCHEMAS", "note_name_to_midi"]

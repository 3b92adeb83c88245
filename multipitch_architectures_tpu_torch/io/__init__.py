"""Host IO: audio and note-event files (``io/audio.py``)."""

from .audio import (NOTE_EVENT_SCHEMAS, NoteEventSchema, load_audio,
                    load_note_events, note_name_to_midi)

__all__ = ["load_audio", "load_note_events", "NoteEventSchema",
           "NOTE_EVENT_SCHEMAS", "note_name_to_midi"]

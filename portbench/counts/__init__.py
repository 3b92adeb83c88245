"""Operations and bytes, counted from a configuration's shapes, never
from the program's modules."""

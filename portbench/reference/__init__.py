"""Plain PyTorch / NumPy references of the benchmark's configurations; they
import nothing of the program under test."""

from .y4m import Y4MReader, Y4MWriter, YUVReader, YUVWriter, read_y4m, write_y4m
